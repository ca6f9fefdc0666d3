"""CDEF of the private av1tpu profile (NORMATIVE): a port of
``av1tpu/encoder/kernels/cdef.py``.  It is not the spec-AV1 CDEF
(``specav1/torch_cdef.py``).

Per 8×8 block, the dominant edge direction (argmin over 8 directions of
the intra-block energy of x minus x shifted along the direction, derived
from the pre-CDEF recon on both sides, so not signaled), then a small
directional low-pass whose tap differences are constrained: primary
taps at distances 1 and 2 along the direction (weights 4, 2), secondary
taps from the two 45°-adjacent directions at distance 1 (weight 1 each
side), total weight 16.  ``constrain(d, s, damping) = sign(d)·min(|d|,
max(0, s − (|d| >> (damping − ⌈log2 s⌉))))``.  Strength from
base_q_idx: ``pri = clamp((q − 40) // 16, 0, 12)``, damping 5 (4 for
chroma); strength 0 is the identity.  Planes may carry leading
dimensions (one per tile stripe).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.encoder.kernels.restoration import edge_pad

# primary tap offsets (dy, dx) at distance 1 and 2 for 8 directions,
# ordered like AV1 (0 = 45°, 2 = horizontal, 4 = 135°, 6 = vertical)
DIRECTIONS = (
    ((-1, 1), (-2, 2)),    # 0: 45° up-right
    ((0, 1), (-1, 2)),     # 1: ~22°
    ((0, 1), (0, 2)),      # 2: horizontal
    ((0, 1), (1, 2)),      # 3: ~-22°
    ((1, 1), (2, 2)),      # 4: 135° (down-right)
    ((1, 0), (2, 1)),      # 5
    ((1, 0), (2, 0)),      # 6: vertical
    ((1, 0), (2, -1)),     # 7
)


def strength_from_qindex(qindex: int) -> int:
    """Primary strength from base_q_idx."""
    return min(max((int(qindex) - 40) // 16, 0), 12)


def _constrain(diff: torch.Tensor, s: int, damping: int) -> torch.Tensor:
    """AV1 constraint: pass large differences, damp small ones.  The
    reference's ceil(log2(s)) in float32 is exact for these strengths;
    here it is the integer's bit length."""
    log2s = (s - 1).bit_length() if s > 0 else 0
    shift = max(0, damping - log2s)
    mag = diff.abs()
    delta = torch.minimum(mag, (s - (mag >> shift)).clamp(min=0))
    return torch.sign(diff) * delta


@functools.lru_cache(maxsize=None)
def _offset_tables():
    """The unique tap offsets used by any direction, and an (8, n_offsets)
    per-direction weight table (the reference's weight-map
    formulation)."""
    offs: list[tuple[int, int]] = []
    index: dict[tuple[int, int], int] = {}

    def oi(o):
        if o not in index:
            index[o] = len(offs)
            offs.append(o)
        return index[o]

    entries = []
    for d, (p1, p2) in enumerate(DIRECTIONS):
        sec_a = DIRECTIONS[(d + 2) % 8][0]
        sec_b = DIRECTIONS[(d - 2) % 8][0]
        for (dy, dx), wgt in ((p1, 4), (p2, 2)):
            for sgn in (1, -1):
                entries.append((d, oi((sgn * dy, sgn * dx)), wgt))
        for (dy, dx) in (sec_a, sec_b):
            for sgn in (1, -1):
                entries.append((d, oi((sgn * dy, sgn * dx)), 1))
    wt = np.zeros((8, len(offs)), np.int32)
    for d, i, wgt in entries:
        wt[d, i] += wgt
    return tuple(offs), wt


def _tap(padded: torch.Tensor, dy: int, dx: int, h: int, w: int):
    """The plane shifted by (dy, dx) from its 2-sample edge padding."""
    return padded[..., 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]


def _block_sum8(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // 8, 8, w // 8, 8).sum(
        (-3, -1), dtype=torch.int32)


def _block_directions(plane: torch.Tensor) -> torch.Tensor:
    """Per-8×8-block dominant direction: the first argmin over directions
    of the summed first-difference energy along both direction steps."""
    from av1tpu_torch.encoder.kernels.motion import first_argmin
    h, w = plane.shape[-2:]
    padded = edge_pad(plane, 2, 2)
    energies: dict[tuple[int, int], torch.Tensor] = {}

    def energy(dy, dx):
        if (dy, dx) not in energies:
            diff = plane - _tap(padded, dy, dx, h, w)
            energies[(dy, dx)] = _block_sum8(diff * diff)
        return energies[(dy, dx)]

    cost = torch.stack([energy(*p1) + energy(*p2)
                        for (p1, p2) in DIRECTIONS], dim=0)
    return first_argmin(cost, 0)


def cdef_plane(rec: torch.Tensor, qindex: int, bit_depth: int = 8,
               is_chroma: bool = False) -> torch.Tensor:
    """Filter int32 recon planes (..., H, W) with H, W multiples of 8."""
    h, w = rec.shape[-2:]
    if h % 8 or w % 8:
        return rec  # only whole 8x8 grids (padded planes qualify)
    s = strength_from_qindex(qindex) << (bit_depth - 8)
    if is_chroma:
        s >>= 1
    damping = (4 if is_chroma else 5) + (bit_depth - 8)
    maxval = (1 << bit_depth) - 1
    dirs = _block_directions(rec)
    offs, wt = _offset_tables()
    wt_t = torch.as_tensor(wt, device=rec.device)
    padded = edge_pad(rec, 2, 2)
    acc = torch.zeros_like(rec)
    for i, (dy, dx) in enumerate(offs):
        c = _constrain(_tap(padded, dy, dx, h, w) - rec, s, damping)
        w_px = wt_t[:, i][dirs].repeat_interleave(8, -2).repeat_interleave(
            8, -1)
        acc = acc + w_px * c
    return (rec + ((acc + 8) >> 4)).clamp(0, maxval)


def gate_errors(src_y: torch.Tensor, rec_y: torch.Tensor,
                cdef_y: torch.Tensor) -> torch.Tensor:
    """The gate's squared errors against the source on 4x4-subsampled
    luma, (CDEF off, CDEF on) as an int64 tensor: exact sums, which add
    up over tile stripes whose heights are multiples of 4."""
    sf = src_y[::4, ::4].to(torch.int64)
    return torch.stack([((p[::4, ::4].to(torch.int64) - sf) ** 2).sum()
                        for p in (rec_y, cdef_y)])


def cdef_gate(src_y: torch.Tensor, rec_y: torch.Tensor,
              cdef_y: torch.Tensor) -> torch.Tensor:
    """Frame-level gate (a bool tensor on the device): keep CDEF only when
    it moves the luma recon toward the source, on 4x4-subsampled planes.
    The reference sums in float32; the port sums exactly."""
    e = gate_errors(src_y, rec_y, cdef_y)
    return e[1] < e[0]


def select(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Whole planes selected by a scalar flag on the device."""
    return torch.where(flag, a, b)

"""Subpel motion-compensated prediction of the private av1tpu profile
(NORMATIVE): a port of ``av1tpu/encoder/kernels/mc.py``.

Quarter-pel luma / eighth-pel chroma interpolation with separable integer
filters, shared bit-exactly by encoder recon and decoder: the filtered
block is a sum of statically-shifted views scaled by per-block
coefficients.

Filter definition (the codec's normative tables): cosine-windowed sinc,
8-tap luma at 4 phases, 4-tap chroma at 8 phases, integer coefficients
summing to 128 (center-tap corrected).  Interpolation arithmetic:
  tmp  = Σ_t region[.., x+t] * fh[t]          (no intermediate rounding)
  out  = clip( rs( Σ_t tmp[.., y+t] * fv[t], 14 ), 0, maxval )
All intermediates fit int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LUMA_TAPS = 8
CHROMA_TAPS = 4
MV_PREC = 2            # quarter-pel: mv units are 1/4 luma pel
FILTER_SUM_LOG2 = 7    # coefficients sum to 128
FINAL_SHIFT = 2 * FILTER_SUM_LOG2


@functools.lru_cache(maxsize=None)
def luma_filters() -> np.ndarray:
    """(4, 8) int32: phases 0, 1/4, 2/4, 3/4."""
    return _make_filters(4, LUMA_TAPS)


@functools.lru_cache(maxsize=None)
def chroma_filters() -> np.ndarray:
    """(8, 4) int32: phases k/8."""
    return _make_filters(8, CHROMA_TAPS)


def _make_filters(n_phases: int, taps: int) -> np.ndarray:
    center = taps // 2 - 1
    out = np.zeros((n_phases, taps), np.int64)
    for p in range(n_phases):
        frac = p / n_phases
        if p == 0:
            out[0, center] = 1 << FILTER_SUM_LOG2
            continue
        t = np.arange(taps, dtype=np.float64) - center - frac
        sinc = np.sinc(t)
        window = np.cos(np.pi * t / taps) ** 2
        f = sinc * window
        f = f / f.sum() * (1 << FILTER_SUM_LOG2)
        fi = np.round(f).astype(np.int64)
        # force exact DC gain by correcting the dominant tap
        fi[np.argmax(np.abs(fi))] += (1 << FILTER_SUM_LOG2) - fi.sum()
        out[p] = fi
    return out.astype(np.int32)


def _coef(coeffs, t: int):
    """Tap t of per-block (B, taps) coefficients, broadcast over (B, H, W),
    or of one (taps,) row (a Python int)."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs[:, t][:, None, None]
    return int(coeffs[t])


def _hfilter(region: torch.Tensor, coeffs, n: int, taps: int):
    """Horizontal pass: region (B, H, n+taps-1+…) → (B, H, n)."""
    acc = None
    for t in range(taps):
        term = region[:, :, t:t + n] * _coef(coeffs, t)
        acc = term if acc is None else acc + term
    return acc


def _vfilter(tmp: torch.Tensor, coeffs, n: int, taps: int):
    acc = None
    for t in range(taps):
        term = tmp[:, t:t + n, :] * _coef(coeffs, t)
        acc = term if acc is None else acc + term
    return acc


_ftabs: dict = {}


def _ftab(filters: np.ndarray, device) -> torch.Tensor:
    key = (filters.shape, str(device))
    t = _ftabs.get(key)
    if t is None:
        t = _ftabs[key] = torch.as_tensor(filters, device=device)
    return t


def interp_block(region: torch.Tensor, phase_y: torch.Tensor,
                 phase_x: torch.Tensor, n: int, filters: np.ndarray,
                 maxval: int = 255) -> torch.Tensor:
    """NORMATIVE subpel interpolation.  region (B, n+taps-1, n+taps-1),
    origin at sample−(taps/2−1); phase_y/phase_x (B,) per-block phases.
    Returns (B, n, n) int32 in [0, maxval]."""
    taps = filters.shape[1]
    ftab = _ftab(filters, region.device)
    fh = ftab[phase_x.to(torch.int64)]
    fv = ftab[phase_y.to(torch.int64)]
    tmp = _hfilter(region.to(torch.int32), fh, n, taps)
    out = _vfilter(tmp, fv, n, taps)
    out = (out + (1 << (FINAL_SHIFT - 1))) >> FINAL_SHIFT
    return out.clamp(0, maxval)


def windows(plane: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
            R: int) -> torch.Tensor:
    """(B, R, R) windows of ``plane`` at in-bounds origins (r, c): the
    tensor gather that stands for the reference's vmap of
    dynamic_slice."""
    ar = torch.arange(R, device=plane.device)
    rows = (r.to(torch.int64)[:, None] + ar)[:, :, None]
    cols = (c.to(torch.int64)[:, None] + ar)[:, None, :]
    return plane[rows, cols]


def gather_regions(ref_pad: torch.Tensor, pos: torch.Tensor,
                   full_mv: torch.Tensor, n: int, taps: int,
                   pad: int) -> torch.Tensor:
    """Gather (B, n+taps-1, n+taps-1) regions at pos+full_mv−(taps/2−1)."""
    R = n + taps - 1
    off = taps // 2 - 1
    hp2, wp2 = ref_pad.shape
    r = (pos[:, 0] + pad + full_mv[:, 0] - off).clamp(0, hp2 - R)
    c = (pos[:, 1] + pad + full_mv[:, 1] - off).clamp(0, wp2 - R)
    return windows(ref_pad, r, c, R)


def predict_subpel_luma(ref_pad: torch.Tensor, pos: torch.Tensor,
                        mv_q: torch.Tensor, n: int, pad: int,
                        maxval: int = 255) -> torch.Tensor:
    """Quarter-pel luma MC: mv_q in q4 units.  (B, n, n) int32."""
    full = mv_q >> MV_PREC
    phase = mv_q & 3
    regions = gather_regions(ref_pad, pos, full, n, LUMA_TAPS, pad)
    return interp_block(regions, phase[:, 0], phase[:, 1], n, luma_filters(),
                        maxval)


def predict_subpel_chroma(ref_pad: torch.Tensor, pos: torch.Tensor,
                          mv_q: torch.Tensor, n: int, pad: int,
                          maxval: int = 255) -> torch.Tensor:
    """Eighth-pel chroma MC from luma q4 MVs: full = mv_q>>3, phase =
    mv_q & 7 (8 phases)."""
    full = mv_q >> 3
    phase = mv_q & 7
    regions = gather_regions(ref_pad, pos, full, n, CHROMA_TAPS, pad)
    return interp_block(regions, phase[:, 0], phase[:, 1], n,
                        chroma_filters(), maxval)

# Copied from av1tpu/specav1/inter_recon.py.
"""Spec-AV1 inter prediction: single-ref translational motion
compensation with exact spec rounding (spec §7.11.3, no ref scaling).

The 16-phase 8-tap filters come from the system libaom .rodata
(tools/extract_cdfs.py, "subpel_regular"); intermediate rounding is
InterRound0/InterRound1 per bit depth.  Used by the host encoder's
reconstruction and the conformance decoder; the device (JAX) encoder
must match this bit-for-bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_NPZ = Path(__file__).resolve().parent.parent / "encoder" / "entropy" / \
    "av1_default_cdfs.npz"
with np.load(_NPZ) as _z:
    SUBPEL_REGULAR = _z["subpel_regular"].astype(np.int32)  # (16, 8)
    SUBPEL_SMOOTH = _z["subpel_smooth"].astype(np.int32)
    SUBPEL_SHARP = _z["subpel_sharp"].astype(np.int32)
    SUBPEL_REGULAR4 = _z["subpel_regular4"].astype(np.int32)
    SUBPEL_SMOOTH4 = _z["subpel_smooth4"].astype(np.int32)

# interp_filter enum order (spec): REGULAR, SMOOTH, SHARP
FILTER_BANKS = (SUBPEL_REGULAR, SUBPEL_SMOOTH, SUBPEL_SHARP)
# 4-tap variants for block dims <= 4 (sharp falls back to regular-4)
FILTER_BANKS_4 = (SUBPEL_REGULAR4, SUBPEL_SMOOTH4, SUBPEL_REGULAR4)

FILTER_BITS = 7


def _rounds(bit_depth: int, is_compound: bool = False):
    if bit_depth == 12:
        return 5, 5 if is_compound else 9
    return 3, 7 if is_compound else 11


def round2(x, n):
    return (x + (1 << (n - 1))) >> n


def predict_inter(ref: np.ndarray, x: int, y: int, w: int, h: int,
                  mv: tuple, ss_x: int, ss_y: int,
                  bit_depth: int, interp_filter: int = 0) -> np.ndarray:
    """Predict a w×h block at plane position (x, y) from `ref` (the
    reference frame's full coded-size plane) with luma MV `mv` =
    (row, col) in 1/8-pel.  `interp_filter` selects the 8-tap bank
    (0 regular / 1 smooth / 2 sharp).  Returns (h, w) int32 pixels."""
    rh, rw = ref.shape
    r0, r1 = _rounds(bit_depth)
    # 1/16-pel plane-space start position
    sy16 = (y << 4) + (int(mv[0]) << (1 - ss_y))
    sx16 = (x << 4) + (int(mv[1]) << (1 - ss_x))
    frac_y, frac_x = sy16 & 15, sx16 & 15
    iy, ix = sy16 >> 4, sx16 >> 4
    fx = (FILTER_BANKS_4 if w <= 4 else FILTER_BANKS)[interp_filter][frac_x]
    fy = (FILTER_BANKS_4 if h <= 4 else FILTER_BANKS)[interp_filter][frac_y]
    # gather (h+7) x (w+7) source window with edge clamping
    rows = np.clip(np.arange(iy - 3, iy + h + 4), 0, rh - 1)
    cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, rw - 1)
    src = ref[np.ix_(rows, cols)].astype(np.int64)
    # horizontal: (h+7, w)
    inter = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        inter += fx[t] * src[:, t:t + w]
    inter = round2(inter, r0)
    # vertical: (h, w)
    out = np.zeros((h, w), np.int64)
    for t in range(8):
        out += fy[t] * inter[t:t + h, :]
    out = round2(out, r1)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)

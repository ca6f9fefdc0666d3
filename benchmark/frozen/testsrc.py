# Frozen copy of av1tpu_torch/utils/testsrc.py (Frame and testsrc2), the benchmark's own source generator.
# Copied from av1tpu/utils/testsrc.py.
"""Synthetic video sources — the ``testsrc2`` analog (SURVEY.md §4e).

Deterministic, hermetic frame generators for self-tests, unit tests, and
benchmarks: gradients, zone plates, moving blocks, and pseudo-noise, in
YUV 4:2:0 at 8 or 10 bits.  The reference's equivalent is ffmpeg's lavfi
``testsrc2`` used by the startup self-test (binary.go:282-295).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Frame:
    """One YUV 4:2:0 frame.  y is (H, W); u/v are (H//2, W//2).

    dtype is uint8 for bit_depth 8, uint16 for bit_depth 10.
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    bit_depth: int = 8

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]


def testsrc2(width: int, height: int, frame_index: int = 0,
             bit_depth: int = 8) -> Frame:
    """Deterministic colorful test pattern with temporal motion.

    Combines a diagonal luma gradient, a zone plate (spatial frequency
    sweep — stresses transforms), a moving bright square (stresses motion
    search), and hash-based pseudo-noise (stresses rate control).
    """
    assert width % 2 == 0 and height % 2 == 0
    maxval = (1 << bit_depth) - 1
    t = frame_index

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)

    # Diagonal gradient, slowly scrolling
    grad = ((xx + yy + 4.0 * t) / (width + height)) % 1.0

    # Zone plate centred mid-frame
    cx, cy = width / 2.0, height / 2.0
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (width * height)
    zone = 0.5 + 0.5 * np.cos(80.0 * np.pi * r2 + 0.1 * t)

    # Moving square
    sq = np.zeros((height, width))
    side = max(16, height // 8)
    sx = int((0.1 * width + 7 * t)) % max(1, width - side)
    sy = int((0.2 * height + 3 * t)) % max(1, height - side)
    sq[sy:sy + side, sx:sx + side] = 1.0

    # Deterministic pseudo-noise (integer hash, no RNG state)
    h = (xx.astype(np.int64) * 73856093 ^ yy.astype(np.int64) * 19349663
         ^ (t * 83492791)) & 0xFFFF
    noise = (h.astype(np.float64) / 65535.0 - 0.5) * 0.06

    yf = 0.55 * grad + 0.25 * zone + 0.2 * sq + noise
    y = np.clip(yf * maxval, 0, maxval)

    # Chroma: slow horizontal/vertical color ramps with motion
    hw, hh = width // 2, height // 2
    cyy, cxx = np.mgrid[0:hh, 0:hw].astype(np.float64)
    uf = 0.5 + 0.45 * np.sin(2 * np.pi * (cxx / hw + 0.02 * t))
    vf = 0.5 + 0.45 * np.cos(2 * np.pi * (cyy / hh - 0.015 * t))
    u = np.clip(uf * maxval, 0, maxval)
    v = np.clip(vf * maxval, 0, maxval)

    dtype = np.uint8 if bit_depth == 8 else np.uint16
    return Frame(y=y.astype(dtype), u=u.astype(dtype), v=v.astype(dtype),
                 bit_depth=bit_depth)


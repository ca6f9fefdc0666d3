# Frozen copy of av1tpu_torch/utils/cleansrc.py (clean_frame), the benchmark's own source generator.
"""A smooth synthetic source: content on which the engine's per-GOP
deblocking decision turns on (``noise_floor <= 1``), which ``testsrc2``
with its pseudo-noise never is.  Used by the smoke script and the tests.
"""

from __future__ import annotations

import numpy as np

from .testsrc import Frame


def clean_frame(w: int, h: int, t: int, scene: int = 0,
                bit_depth: int = 8) -> Frame:
    """A diagonal ramp, a low-frequency wave and a moving square, all
    drifting with ``t``; ``scene`` picks one of two unlike scenes (their
    16x-decimated lumas differ by more than the scene-cut threshold)."""
    mx = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    sgn = -1.0 if scene else 1.0
    base = (xx + yy + 4.0 * t) / (w + h + 256.0)
    if scene:
        base = 1.0 - (xx + (h - yy) + 4.0 * t) / (w + h + 256.0)
    wave = 0.5 + 0.5 * np.cos(2 * np.pi * ((2 + scene) * xx / w
                                           + sgn * 2 * yy / h) + 0.1 * t)
    sq = np.zeros((h, w))
    side = max(16, h // 8)
    sx = int(0.1 * w + 7 * t) % max(1, w - side)
    sy = int((0.2 + 0.4 * scene) * h + 3 * t) % max(1, h - side)
    sq[sy:sy + side, sx:sx + side] = 1.0
    y = np.clip((0.55 * base + 0.25 * wave + 0.2 * sq) * mx, 0, mx)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float64)
    u = (0.5 + 0.45 * np.sin(2 * np.pi * (cxx / (w // 2) + 0.02 * t
                                          + 0.3 * scene))) * mx
    v = (0.5 + 0.45 * np.cos(2 * np.pi * (cyy / (h // 2) - 0.015 * t
                                          + 0.3 * scene))) * mx
    dt = np.uint8 if bit_depth == 8 else np.uint16
    return Frame(y=y.astype(dt), u=u.astype(dt), v=v.astype(dt),
                 bit_depth=bit_depth)

# Frozen copy of chip_smoke.py's grainy_frame and golden_clip's blend step, the benchmark's own source arithmetic.
"""Grain and scene blends over the frozen sources.

``grainy_frame`` is ``testsrc2`` plus seeded uniform luma grain (the
source's noise floor then measures above 1, so the engine leaves the
GOP's deblocking off, as on a grainy web rip).  ``blend`` is one step of
``golden_clip``'s excursion from scene A towards scene B: k fifths of B.
"""

from __future__ import annotations

import numpy as np

from .testsrc import Frame, testsrc2


def grainy_frame(w: int, h: int, i: int, rng, amp: int = 6) -> Frame:
    """testsrc2 plus seeded uniform grain in [-amp, amp] on luma."""
    f = testsrc2(w, h, i)
    y = np.clip(f.y.astype(np.int32) + rng.integers(-amp, amp + 1, f.y.shape),
                0, 255).astype(np.uint8)
    return Frame(y=y, u=f.u, v=f.v)


def blend(fa: Frame, fb: Frame, k: int) -> Frame:
    """k fifths of the way from fa to fb, rounded (golden_clip's step)."""
    return Frame(*(
        (((5 - k) * pa.astype(np.int32) + k * pb.astype(np.int32) + 2)
         // 5).astype(np.uint8)
        for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v))))

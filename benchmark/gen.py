"""The benchmark's one traffic generator.

A traffic mix is a JSON file of parameters under ``traffic/``; this
module turns it, a frame size and a seed into the stream of source frames
that the cell feeds to ``encode_stream``.  The same seed gives the same
frames.  Three kinds of content, all from the frozen sources:

- ``grain``: a pool of ``pool`` frames of ``testsrc2`` plus seeded luma
  grain in [-grain, grain], played forward and then back, so the stream
  never cuts;
- ``clean``: a pool of ``cleansrc`` scene A frames (from a seeded start),
  played forward and back, with an ``excursion`` every ``period`` frames:
  ``blends`` frames stepping towards scene B, then a cut back to A (a
  shot / reverse-shot cut that codes from GOLDEN);
- ``cuts``: every frame a scene of its own (``testsrc2`` at a seeded
  time, rolled, every other one inverted, plus the same grain), each
  differing from the two before it by at least ``min_cut_mad`` in the
  engine's scene-cut measure, so the engine codes every frame as a key.

Pools and excursion frames are made once, in set-up; a cut scene is made
when the encoder's lookahead asks for it.
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen import clips
from benchmark.frozen.cleansrc import clean_frame
from benchmark.frozen.testsrc import Frame, testsrc2


def _thumb(y: np.ndarray) -> np.ndarray:
    """The engine's scene-cut thumbnail: 16x-decimated luma."""
    return y[::16, ::16].astype(np.int32)


def pingpong(i: int, n: int) -> int:
    """Position i of a pool of n played forward, then back, repeating."""
    if n == 1:
        return 0
    p = i % (2 * (n - 1))
    return p if p < n else 2 * (n - 1) - p


class Source:
    """The frames of one traffic mix at one size and seed: ``frame(i)``
    and, iterated, the endless stream."""

    def __init__(self, params: dict, width: int, height: int, seed: int):
        self.params = params
        self.width, self.height = width, height
        self.kind = params["content"]
        self.rng = np.random.default_rng([int(seed), 0])
        amp = int(params.get("grain", 0))
        self._cache: dict = {}
        self.period = 0
        if self.kind == "grain":
            n = int(params["pool"])
            self.pool = [clips.grainy_frame(width, height, t, self.rng, amp)
                         for t in range(n)]
        elif self.kind == "clean":
            n = int(params["pool"])
            t0 = int(self.rng.integers(0, int(params.get("start_range", 1))))
            self.pool = [clean_frame(width, height, t0 + t, 0)
                         for t in range(n)]
            self._excursion(t0)
        elif self.kind == "cuts":
            self.amp = amp
            self.min_mad = float(params["min_cut_mad"])
        else:
            raise ValueError(f"traffic content {self.kind!r}")

    def _excursion(self, t0: int) -> None:
        """The excursion's blends, made once: the period is a whole number
        of pool round trips, so each blend lands on the same pool frame."""
        ex = self.params.get("excursion")
        self.period = 0
        if not ex:
            return
        n = len(self.pool)
        self.period = int(ex["period"])
        self.blends = int(ex["blends"])
        if n > 1 and self.period % (2 * (n - 1)):
            raise ValueError(f"excursion period {self.period} is not a "
                             f"multiple of the pool's round trip "
                             f"{2 * (n - 1)}")
        first = self.period - 2 - self.blends
        for k in range(1, self.blends + 1):
            p = pingpong(first + k, n)
            fb = clean_frame(self.width, self.height, t0 + p, 1)
            self._cache[("blend", k)] = clips.blend(self.pool[p], fb, k)

    def _cut_scene(self, i: int) -> Frame:
        """Scene i: far from scenes i - 1 and i - 2 in the cut measure
        (so neither a flash nor a plain P-frame), drawn from the seed."""
        prev = [self._cache[j] for j in (i - 1, i - 2) if j in self._cache]
        w, h = self.width, self.height
        while True:
            f = testsrc2(w, h, int(self.rng.integers(0, 1 << 16)))
            dy = int(self.rng.integers(0, h))
            dx = int(self.rng.integers(0, w))
            y = np.roll(f.y, (dy, dx), axis=(0, 1)).astype(np.int32)
            if i % 2:
                y = 255 - y
            y = np.clip(y + self.rng.integers(-self.amp, self.amp + 1,
                                              y.shape), 0, 255)
            y = y.astype(np.uint8)
            th = _thumb(y)
            if all(np.abs(th - _thumb(p.y)).mean() >= self.min_mad
                   for p in prev):
                return Frame(y=y, u=f.u, v=f.v)

    def frame(self, i: int) -> Frame:
        if self.kind == "cuts":
            if i not in self._cache:
                for j in range(min(self._cache, default=i), i + 1):
                    if j not in self._cache:
                        self._cache[j] = self._cut_scene(j)
            return self._cache[i]
        n = len(self.pool)
        if self.period:
            pos = i % self.period
            first = self.period - 2 - self.blends
            if first < pos <= first + self.blends:
                return self._cache[("blend", pos - first)]
        return self.pool[pingpong(i, n)]

    def __iter__(self):
        i = 0
        while True:
            yield self.frame(i)
            i += 1

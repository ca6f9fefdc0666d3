# Copied from av1tpu/encoder/ratectrl.py (GateRateController,
# LookaheadRateController).
"""Rate control: the gate-aware and lookahead qindex controllers that
``TorchEngine.encode_stream`` drives (``qindex_for``, ``record``,
``frame_complexity``).  Pure Python.
"""

from __future__ import annotations


class GateRateController:
    """Gate-aware rate control: quality-floored adaptive qindex.

    The reference runs fixed-quality (ICQ) and relies on the daemon's size
    gate to reject outputs that don't shrink (daemon.go:18-21) — a whole
    encode is wasted on rejection.  This controller keeps the ladder
    quality as a FLOOR (qindex never drops below the ladder point, so
    quality parity is preserved) and raises qindex between GOPs when the
    projected output size would fail the gate — converting would-be gate
    rejections into passes.

    Projection: bits-so-far extrapolated to total_frames, compared to
    target_bits; correction uses the ~2^(q/28.8) step curve of the quant
    tables (quant.ac_quant_table).
    """

    MAX_BOOST = 48  # qindex never raised more than this above the ladder

    def __init__(self, base_qindex: int, target_bits: float,
                 total_frames: int, keyint: int):
        import math
        self._math = math
        self.base = base_qindex
        self.q = base_qindex
        self.target_bits = max(1.0, target_bits)
        self.total_frames = max(1, total_frames)
        self.keyint = max(1, keyint)
        # per-frame qindex is legal (each frame header carries its own
        # base_q_idx), so adapt at a short fixed cadence — long GOPs would
        # otherwise leave short clips with no adaptation point at all
        self.adapt_interval = max(1, min(keyint, 16))
        self.bits = 0.0
        self.frames = 0

    def qindex_for(self, frame_idx: int) -> int:
        """Per-frame qindex; adapts every adapt_interval frames."""
        if (frame_idx > 0 and frame_idx % self.adapt_interval == 0
                and self.frames):
            projected = self.bits / self.frames * self.total_frames
            ratio = projected / self.target_bits
            if ratio > 1.0:
                boost = round(28.8 * self._math.log2(ratio))
                self.q = min(self.base + self.MAX_BOOST,
                             max(self.q, self.base + boost))
            elif ratio < 0.85:
                # undershooting: relax toward the quality floor
                self.q = max(self.base, self.q - 4)
        return self.q

    def record(self, frame_bits: int) -> None:
        self.bits += frame_bits
        self.frames += 1


class LookaheadRateController(GateRateController):
    """Window-lookahead, complexity-normalized gate rate control.

    The reactive base class projects bits linearly from the frames seen
    so far — it reacts a full adapt-interval late and assumes future
    content matches the past.  This controller consumes the encode
    pipeline's frame lookahead window (engine_tpu.encode_stream buffers
    L frames): every frame carries a cheap host-side complexity stat
    (downsampled inter-frame difference energy), the observed bits are
    normalized per complexity unit, and the projection prices the
    KNOWN upcoming window at its own complexity plus the remainder at
    the running mean.  A complex scene therefore raises qindex as it
    ENTERS the window rather than 16 frames after it started costing
    bits.  Quality-floor and MAX_BOOST semantics are inherited; q moves
    at most MAX_STEP per frame (per-frame base_q_idx is legal).

    Reference parity: converts daemon.go:18-21 size-gate rejections
    into passes like the base class, with faster, content-led
    convergence (SURVEY §6 "size-gate pass rate at equal quality").
    """

    MAX_STEP = 8

    def __init__(self, base_qindex: int, target_bits: float,
                 total_frames: int, keyint: int, window: int = 16):
        super().__init__(base_qindex, target_bits, total_frames, keyint)
        self.window = max(1, window)
        self._pend: list = []      # cs issued via qindex_for, unrecorded
        self._c_seen = 0.0         # complexity of recorded frames
        self._c_sum = 0.0          # all observed complexity (running mean)
        self._c_n = 0
        self._win_cs: list = []
        self._r = None             # EMA bits-per-complexity

    @staticmethod
    def frame_complexity(y, prev_ds):
        """(complexity, ds) for a luma plane given the previous frame's
        downsample; prev_ds None = first frame (spatial activity).

        Complexity must predict CODING cost, not raw change: a global
        pan is near-free (MC finds it) and smooth morphing transforms
        cheaply, while noise-like residual is expensive.  So the metric
        is the projection-aligned frame difference (cheap global-MC:
        best row/col-profile shift, the _gop_predictable trick) scored
        by its high-frequency energy (second difference — smooth
        residual compacts under the DCT, HF residual doesn't)."""
        import numpy as np
        a = np.asarray(y)[::4, ::4].astype(np.float32)
        if prev_ds is None or prev_ds.shape != a.shape:
            d = a[:, 1:] - a[:, :-1]
        else:
            h, w = a.shape
            R = min(15, h // 4, w // 4)

            def best_shift(p0, p1):
                best, bs = None, 0
                for s in range(-R, R + 1):
                    if s >= 0:
                        m = np.abs(p0[s:] - p1[:len(p1) - s]).mean() \
                            if s else np.abs(p0 - p1).mean()
                    else:
                        m = np.abs(p0[:len(p0) + s] - p1[-s:]).mean()
                    if best is None or m < best:
                        best, bs = m, s
                return bs

            dy = best_shift(a.mean(axis=1), prev_ds.mean(axis=1))
            dx = best_shift(a.mean(axis=0), prev_ds.mean(axis=0))
            a0 = a[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
            p0 = prev_ds[max(-dy, 0):h - max(dy, 0),
                         max(-dx, 0):w - max(dx, 0)]
            d = a0 - p0
        hf = np.abs(d[:, 2:] - 2 * d[:, 1:-1] + d[:, :-2]).mean() \
            if d.shape[1] >= 3 else 0.0
        c = float(hf + 0.25 * np.abs(d).mean())
        return max(c, 0.05), a

    def qindex_for(self, frame_idx: int, c=None, window=None) -> int:
        if c is None:  # legacy call shape: reactive behavior
            return super().qindex_for(frame_idx)
        if window is not None:
            self._win_cs = [float(x) for x in window]
        c = float(c)
        self._pend.append(c)
        self._c_sum += c
        self._c_n += 1
        if self.frames >= 1 and self._c_seen > 0:
            # bits per complexity unit: EMA over recent records (the
            # long-run mean lags content-class changes by the whole
            # history; the EMA tracks within ~5 frames)
            r = self._r if self._r is not None \
                else self.bits / self._c_seen
            # frames submitted but not yet recorded (the dispatch
            # pipeline + chunking delay records by up to ~2 chunks):
            # price them at the model rate so the projection doesn't
            # run a pipeline-depth behind the spend
            pend_c = sum(self._pend)
            stepq = 2.0 ** ((self.base - self.q) / 28.8)
            spent = self.bits + r * stepq * pend_c
            done_f = self.frames + len(self._pend)
            rem_f = max(0, self.total_frames - done_f)
            cbar = self._c_sum / self._c_n
            wn = min(len(self._win_cs), rem_f)
            fut_c = (sum(self._win_cs[:wn]) +
                     max(0, rem_f - wn) * cbar)
            budget_rem = self.target_bits - spent
            # r is normalized to q=base, so ratio solves directly for
            # the q the remaining budget affords: q* = base +
            # 28.8*log2(r*fut_c / budget_rem)
            need = r * fut_c
            if rem_f == 0:
                ratio = 1.0
            elif budget_rem <= need * 0.01:
                ratio = 100.0  # overspent: best-effort max boost
            else:
                ratio = need / budget_rem
            want = self.base
            if ratio > 1.0:
                want = min(
                    self.base + self.MAX_BOOST,
                    self.base + round(
                        28.8 * self._math.log2(min(ratio, 100.0))))
            if want > self.q:
                self.q = min(want, self.q + self.MAX_STEP)
            elif want < self.q - 2:
                self.q = max(self.base, self.q - 4)
        return self.q

    def record(self, frame_bits: int) -> None:
        super().record(frame_bits)
        if self._pend:
            c = self._pend.pop(0)
            self._c_seen += c
            # q-normalized rate sample: divide out the current q's
            # step so the EMA tracks CONTENT, not our own corrections
            step = 2.0 ** ((self.base - self.q) / 28.8)
            sample = frame_bits / c / max(step, 1e-6)
            self._r = sample if self._r is None else \
                0.75 * self._r + 0.25 * sample

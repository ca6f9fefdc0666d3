# Copied from av1tpu/encoder/ratectrl.py.
"""Rate-control policy: quality ladder, qindex mapping, size estimation,
and the gate-aware and lookahead qindex controllers.

The ladder mirrors the reference's resolution-based global_quality selection
(internal/ffmpeg/transcode.go:157-165) and the output-size estimator mirrors
cmd/av1d/main.go:355-461 including its bits-per-pixel-per-frame model
(main.go:417-427).  The ladder-to-AV1-qindex mapping is new (the reference
delegates quality interpretation to the VAAPI stack).  The controllers
are what ``TorchEngine.encode_stream`` drives (``qindex_for``,
``record``, ``frame_complexity``).

Pure Python, so the daemon's scan path stays light.
"""

from __future__ import annotations

from typing import Optional


def determine_quality(height: int) -> int:
    """global_quality by height (transcode.go:157-165).

    >=1440 -> 23; >=1080 -> 24; else 25.
    """
    if height >= 1440:
        return 23
    if height >= 1080:
        return 24
    return 25


# Mapping of the reference's VAAPI global_quality ladder onto AV1 base_q_idx
# (0..255).  VAAPI ICQ quality for av1_vaapi maps roughly like CRF; the
# Arc media stack converts global_quality q to an AV1 quantizer comparable to
# libaom's --cq-level q.  libaom maps cq-level c to qindex ~= 4*c, so
# global_quality 23/24/25 land near qindex 92/96/100.  Tuned constants —
# the size-gate pass-rate parity target (BASELINE.md) is the real spec.
QUALITY_TO_QINDEX = {23: 92, 24: 96, 25: 100}


def quality_to_qindex(quality: int) -> int:
    if quality in QUALITY_TO_QINDEX:
        return QUALITY_TO_QINDEX[quality]
    return max(0, min(255, 4 * quality))


def bits_per_pixel_per_frame(quality: int) -> float:
    """Expected AV1 bits/pixel/frame by ladder point (main.go:417-427)."""
    return {23: 0.15, 24: 0.12, 25: 0.10}.get(quality, 0.12)


def _parse_fps(rate: str) -> Optional[float]:
    """Parse "24000/1001" or "23.976" (main.go:396-411)."""
    if not rate:
        return None
    parts = rate.split("/")
    try:
        if len(parts) == 2:
            num, den = float(parts[0]), float(parts[1])
            if den > 0:
                return num / den
            return None
        return float(rate)
    except ValueError:
        return None


def estimate_output_size(original_size: int, probe_result,
                         quality: int) -> int:
    """Estimated output bytes from bitrate analysis (main.go:355-461).

    Returns 0 when bitrate/duration data is missing, like the reference.
    ``probe_result`` must expose .video_stream, .format (with .duration,
    .bit_rate) and .streams (with .codec_type, .bit_rate).
    """
    vs = probe_result.video_stream
    if vs is None:
        return 0

    try:
        duration = float(probe_result.format.duration)
    except (TypeError, ValueError):
        return 0
    if duration <= 0:
        return 0

    try:
        total_bitrate = float(probe_result.format.bit_rate)
    except (TypeError, ValueError):
        return 0
    if total_bitrate <= 0:
        return 0

    # Video bitrate = total minus audio/subtitle stream bitrates
    video_bitrate = total_bitrate
    for stream in probe_result.streams:
        if stream.codec_type in ("audio", "subtitle") and stream.bit_rate:
            try:
                video_bitrate -= float(stream.bit_rate)
            except ValueError:
                pass

    # If stream bitrates unparseable, assume ~5% audio overhead (main.go:384-389)
    if video_bitrate >= total_bitrate * 0.95:
        video_bitrate = total_bitrate * 0.95

    pixels = float(vs.width * vs.height)
    fps = _parse_fps(vs.avg_frame_rate) or 24.0

    bppf = bits_per_pixel_per_frame(quality)
    estimated_av1_video_bitrate = pixels * bppf * fps
    compression_ratio = estimated_av1_video_bitrate / video_bitrate

    original_video_size = int(original_size * (video_bitrate / total_bitrate))
    estimated_av1_video_size = int(original_video_size * compression_ratio)
    audio_subtitle_size = original_size - original_video_size

    estimated_total = estimated_av1_video_size + audio_subtitle_size
    estimated_total = int(estimated_total * 1.02)  # container overhead

    if estimated_total <= 0:
        return 0
    if estimated_total > original_size:
        estimated_total = int(original_size * 0.95)
    return estimated_total


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

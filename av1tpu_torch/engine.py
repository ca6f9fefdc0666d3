"""Host half of the encode engine that the port's slice needs.

Copied from ``av1tpu/engine_tpu.py`` (a module that imports JAX at
module scope): the GOP/keyframe decisions (``_scene_cut``,
``_decide_key``, ``_classify_frame``, ``_gop_predictable``), plane
padding (``_pad_planes`` with ``legacy.core.intra_frame.pad_plane``),
the entropy worker pool (``_entropy_pool``) and ``encode_stream`` with
its chunk buffer: runs of ``cfg.chunk`` P-frames go to the device as one
dispatch, keyframes, flashes and sub-chunk remainders one frame at a
time; the golden-aware scene cut included.  The port keeps this copy:
it imports nothing of ``av1tpu``.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Optional

import numpy as np

from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.encoder import ratectrl
from av1tpu_torch.utils.testsrc import Frame

_pool = None


def _entropy_pool():
    """Shared worker pool for per-frame host entropy coding (the C++
    range coder releases the GIL; frames carry no shared entropy
    state)."""
    global _pool
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _pool = ThreadPoolExecutor(max_workers=4,
                                   thread_name_prefix="av1torch-ec")
    return _pool


def pad_plane(plane: np.ndarray, block: int) -> np.ndarray:
    """Edge-replicate pad to a multiple of ``block``.  Copied from
    av1tpu/legacy/core/intra_frame.py."""
    h, w = plane.shape
    hp = -(-h // block) * block
    wp = -(-w // block) * block
    return np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge")


class TorchEngine:
    """GOP-level host logic shared by the port's engines.  Subclasses
    provide ``_submit`` (dispatch one frame to the device),
    ``_submit_chunk`` (K P-frames as one dispatch), ``_chunk_cap`` (the
    largest K for a frame size), and ``_finalize`` / ``_finalize_chunk``
    (materialize and entropy-code a dispatch)."""

    def __init__(self, cfg: Optional[TpuEncoderConfig] = None):
        self.cfg = cfg or TpuEncoderConfig()
        self._ref_dev = None       # (y, u, v) int32 recon tensors on device
        self._frame_idx = 0
        self._prev_thumb = None
        self._deep_gop = False
        # two-reference engines: the GOP keyframe's recon (GOLDEN) and
        # its thumb, for cuts back to the scene the GOP opened on
        self._golden = False
        self._golden_dev = None
        self._golden_thumb = None

    def start_stream(self) -> None:
        """Reset GOP state (call once per input video)."""
        self._ref_dev = None
        self._golden_dev = None
        self._frame_idx = 0
        self._prev_thumb = None
        self._golden_thumb = None

    def _scene_cut(self, frame: Frame) -> bool:
        """Mean abs diff of 16x-decimated luma vs the previous frame."""
        thumb = frame.y[::16, ::16].astype(np.int32)
        prev = self._prev_thumb
        self._prev_thumb = thumb
        if prev is None or prev.shape != thumb.shape:
            return False
        mad = np.abs(thumb - prev).mean()
        scale = 1 << (frame.bit_depth - 8)
        return mad > 28.0 * scale

    def _decide_key(self, frame: Frame, force_key: bool = False) -> bool:
        """Keyframe decision (keyint + scene cut); advances GOP state."""
        keyint = max(1, self.cfg.keyint)
        cut = self._scene_cut(frame)
        is_key = (force_key or self._ref_dev is None
                  or (self._frame_idx % keyint == 0) or cut)
        self._frame_idx += 1
        return is_key

    @staticmethod
    def _gop_predictable(frame: Frame, next_frame) -> bool:
        """Lookahead-1 GOP predictability for keyframe bit allocation:
        global translation from 1-D projections, then the
        motion-compensated SAD against the content's 1px-misprediction
        SAD scale."""
        y0 = np.asarray(frame.y)
        y1 = np.asarray(next_frame.y)
        if y0.shape != y1.shape:
            return False
        h, w = y0.shape
        if h < 64 or w < 64:
            return False
        a = y0.astype(np.float64)
        b = y1.astype(np.float64)
        R = 24
        py0, py1 = a.mean(axis=1), b.mean(axis=1)
        px0, px1 = a.mean(axis=0), b.mean(axis=0)

        def best_shift(p0, p1):
            n = p0.shape[0]
            lo = min(R, n // 4)
            best, bs = None, 0
            for s in range(-lo, lo + 1):
                if s >= 0:
                    d = np.abs(p0[s:] - p1[:n - s]) if s else \
                        np.abs(p0 - p1)
                else:
                    d = np.abs(p0[:n + s] - p1[-s:])
                m = d.mean()
                if best is None or m < best:
                    best, bs = m, s
            return bs

        dy = best_shift(py0, py1)
        dx = best_shift(px0, px1)
        sub = 4

        def sad_at(sy, sx):
            y0a = a[max(sy, 0):h + min(sy, 0), max(sx, 0):w + min(sx, 0)]
            y1a = b[max(-sy, 0):h - max(sy, 0),
                    max(-sx, 0):w - max(sx, 0)]
            return np.abs(y0a[::sub, ::sub] - y1a[::sub, ::sub]).mean()

        sad = min(sad_at(dy, dx), sad_at(0, 0))
        act = np.abs(a[::sub, 1:] - a[::sub, :-1]).mean()
        scale = float(1 << (frame.bit_depth - 8))
        return bool(sad < 0.6 * act + 0.25 * scale)

    def _classify_frame(self, frame: Frame, next_frame) -> str:
        """Lookahead-1 classification: 'key' | 'inter' | 'flash' (a
        one-frame scene codes as a non-reference inter frame).  With two
        references, a cut whose content matches the GOP keyframe (a cut
        back to the scene the GOP opened on) codes as a regular inter
        frame: its blocks predict from GOLDEN at P-frame cost."""
        keyint = max(1, self.cfg.keyint)
        thumb = frame.y[::16, ::16].astype(np.int32)
        prev = self._prev_thumb
        scale = 1 << (frame.bit_depth - 8)
        thr = 28.0 * scale
        cut = (prev is not None and prev.shape == thumb.shape
               and np.abs(thumb - prev).mean() > thr)
        forced = (self._ref_dev is None
                  or (self._frame_idx % keyint == 0))
        self._frame_idx += 1
        if cut and not forced and next_frame is not None:
            nt = next_frame.y[::16, ::16].astype(np.int32)
            if (nt.shape == thumb.shape
                    and np.abs(nt - thumb).mean() > thr
                    and np.abs(nt - prev).mean() <= thr):
                return "flash"
        self._prev_thumb = thumb
        if cut and not forced:
            gt = self._golden_thumb
            if (self._golden and gt is not None and gt.shape == thumb.shape
                    and np.abs(thumb - gt).mean() <= thr):
                return "inter"
        if forced or cut:
            self._golden_thumb = thumb
            return "key"
        return "inter"

    @staticmethod
    def _pad_planes(frame: Frame, block: int):
        """Pad Y to block multiples and chroma to half that."""
        dtype = np.uint8 if frame.bit_depth == 8 else np.uint16
        yp = pad_plane(frame.y.astype(dtype), block)
        hp, wp = yp.shape
        up = np.zeros((hp // 2, wp // 2), dtype)
        vp = np.zeros((hp // 2, wp // 2), dtype)
        uu = frame.u.astype(dtype)
        vv = frame.v.astype(dtype)
        up[:uu.shape[0], :uu.shape[1]] = uu
        vp[:vv.shape[0], :vv.shape[1]] = vv
        if uu.shape[0] < up.shape[0]:
            up[uu.shape[0]:, :] = up[uu.shape[0] - 1:uu.shape[0], :]
            vp[vv.shape[0]:, :] = vp[vv.shape[0] - 1:vv.shape[0], :]
        if uu.shape[1] < up.shape[1]:
            up[:, uu.shape[1]:] = up[:, uu.shape[1] - 1:uu.shape[1]]
            vp[:, vv.shape[1]:] = vp[:, vv.shape[1] - 1:vv.shape[1]]
        return yp, up, vp

    def encode_keyframe(self, frame: Frame, qindex: int) -> bytes:
        """Encode one frame as an intra keyframe; returns its payload."""
        payload, _ = self._finalize(self._submit(frame, qindex,
                                                 force_key=True))
        return payload

    def encode_smoke_frame(self, frame: Frame) -> bytes:
        """Startup self-test payload."""
        return self.encode_keyframe(frame, qindex=96)

    def encode_stream(self, frames, qindex):
        """Pipelined GOP encode over an iterable of Frames.  ``qindex``
        is an int or a ratectrl controller.  Yields (payload,
        is_keyframe) in order; up to two dispatches are in flight while
        the host entropy-codes the oldest.  Runs of cfg.chunk
        consecutive P-frames go out as one chunk dispatch; keyframes,
        flashes and sub-chunk remainders one frame at a time."""
        rate = qindex if hasattr(qindex, "qindex_for") else None
        K = max(1, int(getattr(self.cfg, "chunk", 1)))
        frames = iter(frames)
        first = next(frames, None)
        if first is None:
            return
        K = min(K, self._chunk_cap(first.width, first.height,
                                   first.bit_depth))
        frames = itertools.chain([first], frames)
        pending = deque()  # entries: ("single", rec) | ("chunk", rec)
        depth = 2
        idx = 0
        buf = []  # buffered (frame, q) awaiting a full chunk

        def flush_buf():
            if not buf:
                return
            if len(buf) == K and K > 1:
                pending.append(("chunk", self._submit_chunk(
                    [f for f, _ in buf], [q for _, q in buf])))
            else:
                for f, q in buf:
                    pending.append(("single",
                                    self._submit(f, q, is_key=False)))
            buf.clear()

        def finalize_one():
            kind, rec = pending.popleft()
            if kind == "single":
                return [self._finalize(rec)]
            return self._finalize_chunk(rec)

        fbytes = max(1, first.width * first.height *
                     (2 if first.bit_depth > 8 else 1) * 3 // 2)
        L = max(2, min(int(getattr(self.cfg, "lookahead", 16)),
                       max(2, 256_000_000 // fbytes)))
        win = deque()
        wcs = deque()
        _ds = [None]

        def _refill():
            while len(win) < L:
                f = next(frames, None)
                if f is None:
                    break
                cst, _ds[0] = ratectrl.LookaheadRateController.\
                    frame_complexity(f.y, _ds[0])
                win.append(f)
                wcs.append(cst)

        _refill()
        while win:
            frame = win.popleft()
            cur_c = wcs.popleft()
            _refill()
            nxt = win[0] if win else None
            if rate is not None:
                try:
                    q = rate.qindex_for(idx, c=cur_c, window=list(wcs))
                except TypeError:  # non-lookahead controller
                    q = rate.qindex_for(idx)
            else:
                q = qindex
            idx += 1
            kind = self._classify_frame(frame, nxt)
            if kind != "key" and self._deep_gop:
                q = min(255, q + 16)
            if kind == "key":
                flush_buf()  # keep the order: buffered P-frames first
                # keyframe quality boost (deeper for predictable GOPs)
                self._deep_gop = (nxt is not None
                                  and self._gop_predictable(frame, nxt))
                if self._deep_gop:
                    kq = max(0, q - min(88, max(8, (3 * q) // 4)))
                else:
                    kq = max(0, q - min(48, max(8, q // 3)))
                pending.append(("single",
                                self._submit(frame, kq, is_key=True)))
            elif kind == "flash":
                flush_buf()
                pending.append(("single",
                                self._submit(frame, q, is_key=False,
                                             refresh=False)))
            elif K > 1:
                buf.append((frame, q))
                if len(buf) == K:
                    flush_buf()
            else:
                pending.append(("single",
                                self._submit(frame, q, is_key=False)))
            while len(pending) > depth:
                for payload, is_key in finalize_one():
                    if rate:
                        rate.record(len(payload) * 8)
                    yield payload, is_key
        flush_buf()
        while pending:
            for payload, is_key in finalize_one():
                if rate:
                    rate.record(len(payload) * 8)
                yield payload, is_key

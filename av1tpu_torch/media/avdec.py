# Copied from av1tpu/media/avdec.py (the decoder; the library builds into
# av1tpu_torch/_build/, keyed on a content hash of native/).
"""Native source-video decode: libavformat + libavcodec via ctypes.

Replaces the cv2.VideoCapture pixel path in the engine
(engine_tpu.iter_source_frames): decodes any system-supported codec
(H.264, HEVC incl. 10-bit, VP9, MPEG-2, ...) straight to planar I420 at
the source's bit depth — no BGR round-trip, no 8-bit squeeze.  This is
the proper version of the reference's decode stage (the exec'd ffmpeg
child, internal/ffmpeg/transcode.go:25-29), and it closes the
compressed high-bit-depth source hole: the reference pushed HDR10 HEVC
through 8-bit nv12 (transcode.go:99-109, flagged in SURVEY SS2 as a
defect); we decode it at 10 bits for the 10-bit spec encode pipeline.

Falls back gracefully: `available()` is False when the shared lib can't
build/load (no libavcodec dev stack), and callers keep the cv2 path.

The library builds at first use from ``native/`` (this package's own
copy of the sources) into ``av1tpu_torch/_build/libavdec_<hash>.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_lock = threading.Lock()
_lib = None
_lib_err: str | None = None


def _src_hash() -> str:
    """Content hash of the native sources (mtime-independent; git
    checkouts do not preserve mtimes)."""
    h = hashlib.sha256()
    for n in sorted(os.listdir(_NATIVE_DIR)):
        if n.endswith((".cc", ".h")) or n == "Makefile":
            with open(os.path.join(_NATIVE_DIR, n), "rb") as f:
                h.update(n.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def _build() -> str:
    """Build the library for the current source hash if it is not built
    yet (temp name, then an atomic rename); returns its path."""
    path = os.path.join(BUILD_DIR, f"libavdec_{_src_hash()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    subprocess.run(["make", "-C", _NATIVE_DIR, "-s", f"TARGET={tmp}"],
                   check=True, capture_output=True)
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            lib.avdec_quiet()
            lib.avdec_open.restype = ctypes.c_void_p
            lib.avdec_open.argtypes = [ctypes.c_char_p]
            lib.avdec_error.restype = ctypes.c_char_p
            lib.avdec_error.argtypes = [ctypes.c_void_p]
            for fn in ("avdec_width", "avdec_height", "avdec_bit_depth"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.avdec_frame_rate.restype = ctypes.c_double
            lib.avdec_frame_rate.argtypes = [ctypes.c_void_p]
            lib.avdec_read.restype = ctypes.c_int
            lib.avdec_read.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.POINTER(ctypes.c_int64)]
            lib.avdec_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:  # missing toolchain/libs: stay optional
            _lib_err = str(e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    bit_depth: int
    pts_ns: int | None


class SourceDecoder:
    """Iterates decoded I420 frames of the main video stream."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"libavdec unavailable: {_lib_err}")
        self._lib = lib
        self._h = lib.avdec_open(path.encode())
        err = lib.avdec_error(self._h)
        if err:
            msg = err.decode(errors="replace")
            self.close()
            raise RuntimeError(f"avdec_open({path}): {msg}")
        self.width = lib.avdec_width(self._h)
        self.height = lib.avdec_height(self._h)
        self.bit_depth = lib.avdec_bit_depth(self._h)
        self.frame_rate = lib.avdec_frame_rate(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avdec_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[DecodedFrame]:
        lib, h = self._lib, self._h
        w, hh = self.width, self.height
        dt = np.uint8 if self.bit_depth == 8 else np.uint16
        pts = ctypes.c_int64()
        while True:
            y = np.empty((hh, w), dt)
            u = np.empty((hh // 2, w // 2), dt)
            v = np.empty((hh // 2, w // 2), dt)
            rc = lib.avdec_read(
                h, y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p), ctypes.byref(pts))
            if rc == 0:
                return
            if rc < 0:
                err = lib.avdec_error(h)
                raise RuntimeError(
                    "decode failed: " +
                    (err.decode(errors="replace") if err else "?"))
            p = None if pts.value == -(2 ** 63) else int(pts.value)
            yield DecodedFrame(y=y, u=u, v=v, bit_depth=self.bit_depth,
                               pts_ns=p)


# Copied from av1tpu/conformance/aomcodec.py (the decoder half: library
# load, image-layout calibration, available, Decoder, decode_stream).
"""ctypes binding of the system libaom decoder.

No dev headers are needed, only ``libaom.so.3``.  The public functions
have a stable C ABI; the structs this module touches
(``aom_codec_ctx_t``, ``aom_image_t``) are version-sensitive, so
instead of hardcoding offsets it *self-calibrates*:

  * ABI versions are probed: ``aom_codec_dec_init_ver`` returns
    ``AOM_CODEC_ABI_MISMATCH`` (3) for wrong versions, so we scan.
  * ``aom_image_t`` field offsets are located by allocating an image
    with distinctive dimensions and scanning the struct bytes for them
    (then finding the plane-pointer triple that points into the heap).

Used by the daemon's decode-verify gate before atomically replacing
user files (daemon/core.py verify_output_av1).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np

# --- aom_codec_err_t ---
AOM_CODEC_OK = 0
AOM_CODEC_ABI_MISMATCH = 3

# --- aom_img_fmt_t ---
AOM_IMG_FMT_PLANAR = 0x100
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
AOM_IMG_FMT_I420 = AOM_IMG_FMT_PLANAR | 2

_CTX_BYTES = 512        # generous over-allocation for aom_codec_ctx_t

_LIB_CANDIDATES = (
    "libaom.so.3",
    "libaom.so",
)


class AomError(RuntimeError):
    pass


def _load_lib():
    for name in _LIB_CANDIDATES:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


_lock = threading.Lock()
_state: dict = {}


def _lib():
    """Load + prototype libaom once; returns None when unavailable."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        lib = _load_lib()
        if lib is not None:
            c = ctypes
            lib.aom_codec_av1_dx.restype = c.c_void_p
            lib.aom_codec_dec_init_ver.restype = c.c_int
            lib.aom_codec_dec_init_ver.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_long, c.c_int]
            lib.aom_codec_decode.restype = c.c_int
            lib.aom_codec_decode.argtypes = [
                c.c_void_p, c.c_char_p, c.c_size_t, c.c_void_p]
            lib.aom_codec_get_frame.restype = c.c_void_p
            lib.aom_codec_get_frame.argtypes = [c.c_void_p, c.c_void_p]
            lib.aom_codec_destroy.restype = c.c_int
            lib.aom_codec_destroy.argtypes = [c.c_void_p]
            lib.aom_img_alloc.restype = c.c_void_p
            lib.aom_img_alloc.argtypes = [
                c.c_void_p, c.c_int, c.c_uint, c.c_uint, c.c_uint]
            lib.aom_img_free.restype = None
            lib.aom_img_free.argtypes = [c.c_void_p]
            lib.aom_codec_error.restype = c.c_char_p
            lib.aom_codec_error.argtypes = [c.c_void_p]
            lib.aom_codec_error_detail.restype = c.c_char_p
            lib.aom_codec_error_detail.argtypes = [c.c_void_p]
            lib.aom_codec_version_str.restype = c.c_char_p
        _state["lib"] = lib
        return lib


def available() -> bool:
    return _lib() is not None


def version() -> str:
    lib = _lib()
    return lib.aom_codec_version_str().decode() if lib else "unavailable"


# ---------------------------------------------------------------------------
# self-calibration
# ---------------------------------------------------------------------------

@dataclass
class _ImageLayout:
    """Byte offsets into aom_image_t, located empirically."""
    fmt: int = 0            # aom_img_fmt_t is the first field (all versions)
    d_w: int = -1
    d_h: int = -1
    bit_depth: int = -1
    x_chroma_shift: int = -1
    planes: int = -1        # unsigned char *planes[3]
    stride: int = -1        # int stride[3] (immediately after planes)


def _u32s(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, dtype="<u4")


def _calibrate_image() -> _ImageLayout:
    """Allocate an image with distinctive dims and locate field offsets."""
    lib = _lib()
    W, H = 852, 482  # distinctive, even, -> aligned w=864? (impl-defined)
    ptr = lib.aom_img_alloc(None, AOM_IMG_FMT_I420, W, H, 32)
    if not ptr:
        raise AomError("aom_img_alloc failed during calibration")
    try:
        raw = ctypes.string_at(ptr, 512)
        u32 = _u32s(raw)
        lay = _ImageLayout()
        # two adjacent (W, H) u32 pairs exist: stored w/h first, then
        # display d_w/d_h — we want the display pair (the stored one may
        # be alignment-padded on decoded streams)
        pairs = [i for i in range(len(u32) - 1)
                 if u32[i] == W and u32[i + 1] == H]
        if not pairs:
            raise AomError("aom_image_t: dims not found")
        lay.d_w, lay.d_h = 4 * pairs[-1], 4 * pairs[-1] + 4
        # bit_depth == 8 sits between the stored and display dim pairs
        for i in range(pairs[0] + 2, pairs[-1] + 1):
            if u32[i] == 8:
                lay.bit_depth = 4 * i
                break
        # chroma shifts: the first adjacent (1, 1) u32 pair after d_h
        for i in range(lay.d_h // 4 + 1, len(u32) - 1):
            if u32[i] == 1 and u32[i + 1] == 1:
                lay.x_chroma_shift = 4 * i
                break
        # planes[3]: first three consecutive u64 heap pointers, 8-aligned,
        # where planes[1] > planes[0] and planes[2] > planes[1] (contiguous
        # alloc) — scan on 8-byte alignment.
        u64 = np.frombuffer(raw, dtype="<u8")
        for i in range(len(u64) - 2):
            a, b, c = int(u64[i]), int(u64[i + 1]), int(u64[i + 2])
            if a > 0x10000 and b > a and c > b and (b - a) < (1 << 32) \
                    and (c - b) < (1 << 32):
                lay.planes = 8 * i
                break
        if lay.planes < 0:
            raise AomError("aom_image_t: planes[] not found")
        lay.stride = lay.planes + 24
        s = np.frombuffer(raw[lay.stride:lay.stride + 12], dtype="<i4")
        if not (s[0] >= W and s[1] >= W // 2 and s[2] == s[1]):
            raise AomError(f"aom_image_t: implausible strides {s}")
        return lay
    finally:
        lib.aom_img_free(ptr)


def _image_layout() -> _ImageLayout:
    with _lock:
        if "imglayout" not in _state:
            _state["imglayout"] = None
    # calibrate outside the lock guard (idempotent)
    if _state["imglayout"] is None:
        _state["imglayout"] = _calibrate_image()
    return _state["imglayout"]


def _probe_abi(init_fn, iface, cfg) -> int:
    """Scan ABI version ints until init stops reporting ABI_MISMATCH."""
    lib = _lib()
    for ver in range(64):
        ctx = ctypes.create_string_buffer(_CTX_BYTES)
        rc = init_fn(ctx, iface, cfg, 0, ver)
        if rc == AOM_CODEC_OK:
            lib.aom_codec_destroy(ctx)
            return ver
        if rc != AOM_CODEC_ABI_MISMATCH:
            raise AomError(f"codec init failed rc={rc} at ver={ver}")
    raise AomError("no working ABI version found")


def _dec_abi() -> int:
    if _state.get("dec_abi") is None:
        lib = _lib()
        _state["dec_abi"] = _probe_abi(
            lib.aom_codec_dec_init_ver,
            ctypes.c_void_p(lib.aom_codec_av1_dx()), None)
    return _state["dec_abi"]


# ---------------------------------------------------------------------------
# image read/write helpers
# ---------------------------------------------------------------------------

def _read_image(img_ptr: int):
    """Read (y, u, v, bit_depth) numpy copies out of an aom_image_t*."""
    lay = _image_layout()
    raw = ctypes.string_at(img_ptr, 512)

    def u32(off):
        return int(np.frombuffer(raw[off:off + 4], dtype="<u4")[0])

    def u64(off):
        return int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])

    fmt = u32(lay.fmt)
    w, h = u32(lay.d_w), u32(lay.d_h)
    bd = u32(lay.bit_depth) if lay.bit_depth >= 0 else 8
    hbd = bool(fmt & AOM_IMG_FMT_HIGHBITDEPTH)
    strides = np.frombuffer(raw[lay.stride:lay.stride + 12], dtype="<i4")
    cw, ch = (w + 1) // 2, (h + 1) // 2
    dt = np.uint16 if hbd else np.uint8
    px = 2 if hbd else 1
    planes = []
    for p, (pw, ph) in enumerate(((w, h), (cw, ch), (cw, ch))):
        base = u64(lay.planes + 8 * p)
        stride = int(strides[p])
        buf = ctypes.string_at(base, stride * ph)
        arr = np.frombuffer(buf, dtype=dt).reshape(ph, stride // px)[:, :pw]
        planes.append(arr.copy())
    return planes[0], planes[1], planes[2], bd


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class Decoder:
    """Streaming spec-AV1 decoder (one temporal unit per decode call)."""

    def __init__(self):
        lib = _lib()
        if lib is None:
            raise AomError("libaom not available")
        self._lib = lib
        self._ctx = ctypes.create_string_buffer(_CTX_BYTES)
        rc = lib.aom_codec_dec_init_ver(
            self._ctx, ctypes.c_void_p(lib.aom_codec_av1_dx()), None, 0,
            _dec_abi())
        if rc != AOM_CODEC_OK:
            raise AomError(f"decoder init rc={rc}")
        self._open = True

    def decode(self, tu: bytes):
        """Decode one temporal unit; returns list of (y, u, v, bit_depth)."""
        rc = self._lib.aom_codec_decode(self._ctx, tu, len(tu), None)
        if rc != AOM_CODEC_OK:
            detail = self._lib.aom_codec_error_detail(self._ctx)
            err = self._lib.aom_codec_error(self._ctx)
            raise AomError(
                f"decode rc={rc}: {err and err.decode()} / "
                f"{detail and detail.decode()}")
        out = []
        it = ctypes.c_void_p(None)
        while True:
            img = self._lib.aom_codec_get_frame(self._ctx,
                                                ctypes.byref(it))
            if not img:
                break
            out.append(_read_image(img))
        return out

    def close(self):
        if self._open:
            self._lib.aom_codec_destroy(self._ctx)
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def decode_stream(tus) -> list:
    """Decode a sequence of temporal units; returns [(y,u,v,bd), ...]."""
    with Decoder() as d:
        frames = []
        for tu in tus:
            frames.extend(d.decode(bytes(tu)))
        return frames

"""Frozen copy of the decode half of av1tpu/conformance/aomcodec.py: a
ctypes binding of libaom, the reference AV1 decoder, that reads no
header files.  The library is the benchmark's own copy,
``aom/libaom.so.3`` (libaom 3.6.0 as Debian 12 builds it, needing only
libc and libm; its licence in ``aom/copyright.txt``), so every machine
decodes with the same build; the system's libaom stands in where that
copy does not load.

The structs it touches are located at run time: the decoder's ABI
version is found by scanning (``aom_codec_dec_init_ver`` answers
``AOM_CODEC_ABI_MISMATCH`` to a wrong one), and the fields of
``aom_image_t`` by allocating an image of distinctive size and finding
its numbers in the struct's bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

AOM_CODEC_OK = 0
AOM_CODEC_ABI_MISMATCH = 3
AOM_IMG_FMT_I420 = 0x100 | 2
AOM_IMG_FMT_HIGHBITDEPTH = 0x800

_CTX_BYTES = 512        # more than aom_codec_ctx_t takes
_OWN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "aom",
                    "libaom.so.3")
_state: dict = {}


class AomError(RuntimeError):
    pass


def _lib():
    """libaom, prototyped once; None where the system has none."""
    if "lib" in _state:
        return _state["lib"]
    lib = None
    for name in (_OWN, "libaom.so.3", "libaom.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
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


def version() -> str:
    lib = _lib()
    return lib.aom_codec_version_str().decode() if lib else "unavailable"


def _image_layout() -> dict:
    """Byte offsets of ``aom_image_t``'s display size (d_w, d_h), its
    plane pointers and its strides."""
    if "layout" in _state:
        return _state["layout"]
    lib = _lib()
    W, H = 852, 482
    ptr = lib.aom_img_alloc(None, AOM_IMG_FMT_I420, W, H, 32)
    if not ptr:
        raise AomError("aom_img_alloc failed")
    try:
        raw = ctypes.string_at(ptr, 512)
        u32 = np.frombuffer(raw, dtype="<u4")
        # the stored size comes first, then the display size d_w, d_h
        pairs = [i for i in range(len(u32) - 1)
                 if u32[i] == W and u32[i + 1] == H]
        if not pairs:
            raise AomError("aom_image_t: sizes not found")
        u64 = np.frombuffer(raw, dtype="<u8")
        planes = -1
        for i in range(len(u64) - 2):
            a, b, c = int(u64[i]), int(u64[i + 1]), int(u64[i + 2])
            if a > 0x10000 and b > a and c > b and b - a < 1 << 32 \
                    and c - b < 1 << 32:
                planes = 8 * i
                break
        if planes < 0:
            raise AomError("aom_image_t: planes[] not found")
        s = np.frombuffer(raw[planes + 24:planes + 36], dtype="<i4")
        if not (s[0] >= W and s[1] >= W // 2 and s[2] == s[1]):
            raise AomError(f"aom_image_t: implausible strides {s}")
        _state["layout"] = {"d_w": 4 * pairs[-1], "d_h": 4 * pairs[-1] + 4,
                            "planes": planes, "stride": planes + 24}
        return _state["layout"]
    finally:
        lib.aom_img_free(ptr)


def _dec_abi() -> int:
    if "abi" not in _state:
        lib = _lib()
        for ver in range(64):
            ctx = ctypes.create_string_buffer(_CTX_BYTES)
            rc = lib.aom_codec_dec_init_ver(
                ctx, ctypes.c_void_p(lib.aom_codec_av1_dx()), None, 0, ver)
            if rc == AOM_CODEC_OK:
                lib.aom_codec_destroy(ctx)
                _state["abi"] = ver
                break
            if rc != AOM_CODEC_ABI_MISMATCH:
                raise AomError(f"decoder init rc={rc} at ABI {ver}")
        else:
            raise AomError("no working decoder ABI version")
    return _state["abi"]


def _read_image(img_ptr: int):
    """(y, u, v) copies out of an ``aom_image_t*``: uint8, or uint16
    where libaom keeps the frame in 16-bit buffers."""
    lay = _image_layout()
    raw = ctypes.string_at(img_ptr, 512)

    def num(off, dt):
        return int(np.frombuffer(raw[off:off + np.dtype(dt).itemsize],
                                 dtype=dt)[0])

    w, h = num(lay["d_w"], "<u4"), num(lay["d_h"], "<u4")
    hbd = bool(num(0, "<u4") & AOM_IMG_FMT_HIGHBITDEPTH)
    strides = np.frombuffer(raw[lay["stride"]:lay["stride"] + 12], "<i4")
    dt, px = (np.uint16, 2) if hbd else (np.uint8, 1)
    out = []
    for p, (pw, ph) in enumerate(((w, h), ((w + 1) // 2, (h + 1) // 2),
                                  ((w + 1) // 2, (h + 1) // 2))):
        base = num(lay["planes"] + 8 * p, "<u8")
        stride = int(strides[p])
        buf = ctypes.string_at(base, stride * ph)
        out.append(np.frombuffer(buf, dtype=dt).reshape(
            ph, stride // px)[:, :pw].copy())
    return tuple(out)


class Decoder:
    """libaom's AV1 decoder, one temporal unit a call, on ``threads``
    threads (its row and loop-filter threads: the same output)."""

    def __init__(self, threads: int = 1):
        lib = _lib()
        if lib is None:
            raise AomError("no libaom loads here")
        self._lib = lib
        self._ctx = ctypes.create_string_buffer(_CTX_BYTES)
        # aom_codec_dec_cfg_t: threads, w, h, allow_lowbitdepth
        self._cfg = (ctypes.c_uint * 4)(threads, 0, 0, 1)
        rc = lib.aom_codec_dec_init_ver(
            self._ctx, ctypes.c_void_p(lib.aom_codec_av1_dx()),
            ctypes.byref(self._cfg), 0, _dec_abi())
        if rc != AOM_CODEC_OK:
            raise AomError(f"decoder init rc={rc}")

    def decode(self, tu: bytes, read: bool = True) -> list:
        """The frames the temporal unit shows, as (y, u, v); with
        ``read`` False only their count (as a list of Nones)."""
        rc = self._lib.aom_codec_decode(self._ctx, tu, len(tu), None)
        if rc != AOM_CODEC_OK:
            err = self._lib.aom_codec_error(self._ctx)
            detail = self._lib.aom_codec_error_detail(self._ctx)
            raise AomError(f"decode rc={rc}: {err and err.decode()} / "
                           f"{detail and detail.decode()}")
        out = []
        it = ctypes.c_void_p(None)
        while True:
            img = self._lib.aom_codec_get_frame(self._ctx, ctypes.byref(it))
            if not img:
                return out
            out.append(_read_image(img) if read else None)

    def close(self):
        if self._ctx is not None:
            self._lib.aom_codec_destroy(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

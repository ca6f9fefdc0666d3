# Copied from av1tpu/conformance/aomcodec.py.
"""ctypes binding of the system libaom (spec AV1 encoder + decoder).

No dev headers exist in the container, only ``libaom.so.3``.  The
public functions have a stable C ABI; the structs we must touch
(``aom_codec_ctx_t``, ``aom_image_t``, ``aom_codec_enc_cfg_t``,
``aom_codec_cx_pkt_t``) are version-sensitive, so instead of hardcoding
offsets from memory this module *self-calibrates*:

  * ABI versions are probed: ``aom_codec_dec_init_ver`` returns
    ``AOM_CODEC_ABI_MISMATCH`` (3) for wrong versions, so we scan.
  * ``aom_image_t`` field offsets are located by allocating an image
    with distinctive dimensions and scanning the struct bytes for them
    (then finding the plane-pointer triple that points into the heap).
  * ``aom_codec_enc_cfg_t`` offsets are located by scanning the buffer
    filled by ``aom_codec_enc_config_default`` for its documented
    defaults (g_w=320 g_h=240 adjacency, timebase 1/30, ...).

Used by the daemon's decode-verify gate before atomically replacing
user files (daemon/core.py verify_output_av1); the encoder half makes
known-good streams for the tests.  No card path uses it: the card's
machine has no libaom.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from dataclasses import dataclass, field

import numpy as np

# --- aom_codec_err_t ---
AOM_CODEC_OK = 0
AOM_CODEC_ABI_MISMATCH = 3

# --- aom_img_fmt_t ---
AOM_IMG_FMT_PLANAR = 0x100
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
AOM_IMG_FMT_I420 = AOM_IMG_FMT_PLANAR | 2
AOM_IMG_FMT_I42016 = AOM_IMG_FMT_I420 | AOM_IMG_FMT_HIGHBITDEPTH

# --- usages (aom_encoder.h) ---
AOM_USAGE_GOOD_QUALITY = 0
AOM_USAGE_REALTIME = 1
AOM_USAGE_ALL_INTRA = 2

# --- selected aome/av1e control IDs (aom/aomcx.h, stable since 1.0) ---
AOME_SET_CPUUSED = 13
AOME_SET_CQ_LEVEL = 25
AV1E_SET_ROW_MT = 118

_CTX_BYTES = 512        # generous over-allocation for aom_codec_ctx_t
_ENC_CFG_BYTES = 8192   # generous over-allocation for aom_codec_enc_cfg_t

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
            lib.aom_codec_av1_cx.restype = c.c_void_p
            lib.aom_codec_dec_init_ver.restype = c.c_int
            lib.aom_codec_dec_init_ver.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_long, c.c_int]
            lib.aom_codec_enc_init_ver.restype = c.c_int
            lib.aom_codec_enc_init_ver.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_long, c.c_int]
            lib.aom_codec_enc_config_default.restype = c.c_int
            lib.aom_codec_enc_config_default.argtypes = [
                c.c_void_p, c.c_void_p, c.c_uint]
            lib.aom_codec_decode.restype = c.c_int
            lib.aom_codec_decode.argtypes = [
                c.c_void_p, c.c_char_p, c.c_size_t, c.c_void_p]
            lib.aom_codec_get_frame.restype = c.c_void_p
            lib.aom_codec_get_frame.argtypes = [c.c_void_p, c.c_void_p]
            lib.aom_codec_encode.restype = c.c_int
            lib.aom_codec_encode.argtypes = [
                c.c_void_p, c.c_void_p, c.c_long, c.c_ulong, c.c_long]
            lib.aom_codec_get_cx_data.restype = c.c_void_p
            lib.aom_codec_get_cx_data.argtypes = [c.c_void_p, c.c_void_p]
            lib.aom_codec_destroy.restype = c.c_int
            lib.aom_codec_destroy.argtypes = [c.c_void_p]
            lib.aom_codec_control.restype = c.c_int
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


@dataclass
class _EncCfgLayout:
    """Byte offsets into aom_codec_enc_cfg_t, located from defaults."""
    size: int = _ENC_CFG_BYTES
    g_usage: int = 0          # first field in every libaom version
    g_threads: int = 4        # second field
    g_w: int = -1
    g_h: int = -1
    g_timebase: int = -1      # {num, den}
    g_lag_in_frames: int = -1
    g_bit_depth: int = -1
    g_input_bit_depth: int = -1
    g_profile: int = -1
    rc_end_usage: int = -1
    rc_min_quantizer: int = -1
    rc_max_quantizer: int = -1
    rc_target_bitrate: int = -1
    kf_max_dist: int = -1
    defaults: bytes = field(default=b"", repr=False)


def _calibrate_enc_cfg() -> _EncCfgLayout:
    lib = _lib()
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    cfg = ctypes.create_string_buffer(_ENC_CFG_BYTES)
    rc = lib.aom_codec_enc_config_default(iface, cfg, AOM_USAGE_GOOD_QUALITY)
    if rc != AOM_CODEC_OK:
        raise AomError(f"enc_config_default rc={rc}")
    u32 = _u32s(cfg.raw)
    lay = _EncCfgLayout(defaults=bytes(cfg.raw))
    # g_w=320, g_h=240 adjacent (documented defaults)
    for i in range(len(u32) - 1):
        if u32[i] == 320 and u32[i + 1] == 240:
            lay.g_w, lay.g_h = 4 * i, 4 * (i + 1)
            break
    if lay.g_w < 0:
        raise AomError("enc_cfg: g_w/g_h not found")
    # g_profile: the u32 immediately before g_w (order: g_profile, g_w, g_h)
    lay.g_profile = lay.g_w - 4
    # bit depths: adjacent (8, 8) pair after g_h, followed soon by
    # timebase {1, 30}
    base = lay.g_h // 4
    for i in range(base, base + 16):
        if u32[i] == 8 and u32[i + 1] == 8:
            lay.g_bit_depth, lay.g_input_bit_depth = 4 * i, 4 * (i + 1)
            break
    for i in range(base, base + 24):
        if u32[i] == 1 and u32[i + 1] == 30:
            lay.g_timebase = 4 * i
            break
    if lay.g_timebase < 0:
        raise AomError("enc_cfg: g_timebase not found")
    # g_lag_in_frames: nonzero for good-quality usage (35 in v3.6), 0 for
    # ALL_INTRA — locate by diffing the two defaults just after timebase.
    cfg2 = ctypes.create_string_buffer(_ENC_CFG_BYTES)
    lib.aom_codec_enc_config_default(iface, cfg2, AOM_USAGE_ALL_INTRA)
    u32b = _u32s(cfg2.raw)
    tb = lay.g_timebase // 4
    for i in range(tb + 2, tb + 8):
        if 0 < u32[i] <= 48 and u32b[i] == 0:
            lay.g_lag_in_frames = 4 * i
            break
    # rc_end_usage: AOM_VBR(0) for good-quality, AOM_Q(3) for ALL_INTRA
    for i in range(tb, tb + 24):
        if u32[i] == 0 and u32b[i] == 3:
            lay.rc_end_usage = 4 * i
            break
    # rc_target_bitrate: documented default 256 (kbps) in both usages;
    # rc_min/max_quantizer follow it immediately (0, 63)
    for i in range(tb, len(u32) - 2):
        if u32[i] == 256 and u32b[i] == 256 and u32[i + 2] == 63:
            lay.rc_target_bitrate = 4 * i
            lay.rc_min_quantizer = 4 * (i + 1)
            lay.rc_max_quantizer = 4 * (i + 2)
            break
    # kf_max_dist: documented default 9999 in good-quality usage
    for i in range(len(u32)):
        if u32[i] == 9999:
            lay.kf_max_dist = 4 * i
            break
    return lay


def _enc_cfg_layout() -> _EncCfgLayout:
    if _state.get("enccfg") is None:
        _state["enccfg"] = _calibrate_enc_cfg()
    return _state["enccfg"]


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


def _fill_image(img_ptr: int, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                hbd: bool) -> None:
    lay = _image_layout()
    raw = ctypes.string_at(img_ptr, 512)
    strides = np.frombuffer(raw[lay.stride:lay.stride + 12], dtype="<i4")
    ptrs = np.frombuffer(raw[lay.planes:lay.planes + 24], dtype="<u8")
    dt = np.uint16 if hbd else np.uint8
    px = 2 if hbd else 1
    for p, plane in enumerate((y, u, v)):
        ph, pw = plane.shape
        stride = int(strides[p])
        row = np.zeros((ph, stride // px), dt)
        row[:, :pw] = plane.astype(dt)
        ctypes.memmove(int(ptrs[p]), row.tobytes(), stride * ph)


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


class Encoder:
    """Spec-AV1 encoder (libaom) for generating known-good streams."""

    def __init__(self, w: int, h: int, *, bit_depth: int = 8,
                 usage: int = AOM_USAGE_GOOD_QUALITY, cpu_used: int = 6,
                 cq_level: int | None = None, threads: int = 4,
                 kf_max_dist: int | None = None):
        lib = _lib()
        if lib is None:
            raise AomError("libaom not available")
        self._lib = lib
        lay = _enc_cfg_layout()
        cfg = ctypes.create_string_buffer(lay.defaults, lay.size)
        rc = lib.aom_codec_enc_config_default(
            ctypes.c_void_p(lib.aom_codec_av1_cx()), cfg, usage)
        if rc != AOM_CODEC_OK:
            raise AomError(f"enc_config_default rc={rc}")

        def set32(off, val):
            if off >= 0:
                ctypes.memmove(ctypes.addressof(cfg) + off,
                               int(val).to_bytes(4, "little"), 4)

        set32(lay.g_w, w)
        set32(lay.g_h, h)
        set32(lay.g_threads, threads)
        set32(lay.g_lag_in_frames, 0)
        if cq_level is not None:
            set32(lay.rc_end_usage, 3)  # AOM_Q: constant-quality mode
        if bit_depth > 8:
            set32(lay.g_profile, 0 if bit_depth == 10 else 2)
            set32(lay.g_bit_depth, bit_depth)
            set32(lay.g_input_bit_depth, bit_depth)
        if kf_max_dist is not None:
            set32(lay.kf_max_dist, kf_max_dist)

        if _state.get("enc_abi") is None:
            _state["enc_abi"] = _probe_abi(
                lib.aom_codec_enc_init_ver,
                ctypes.c_void_p(lib.aom_codec_av1_cx()), cfg)
        self._ctx = ctypes.create_string_buffer(_CTX_BYTES)
        flags = 0x40000 if bit_depth > 8 else 0  # AOM_CODEC_USE_HIGHBITDEPTH
        rc = lib.aom_codec_enc_init_ver(
            self._ctx, ctypes.c_void_p(lib.aom_codec_av1_cx()), cfg,
            flags, _state["enc_abi"])
        if rc != AOM_CODEC_OK:
            raise AomError(f"encoder init rc={rc}")
        self._open = True
        self._w, self._h, self._bd = w, h, bit_depth
        self._pts = 0
        lib.aom_codec_control(self._ctx, AOME_SET_CPUUSED, cpu_used)
        if cq_level is not None:
            lib.aom_codec_control(self._ctx, AOME_SET_CQ_LEVEL, cq_level)

    def set_option(self, name: str, value: str) -> bool:
        """aom_codec_set_option (e.g. 'enable-cdef', '0'); True on ok."""
        self._lib.aom_codec_set_option.restype = ctypes.c_int
        self._lib.aom_codec_set_option.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        rc = self._lib.aom_codec_set_option(
            self._ctx, name.encode(), str(value).encode())
        return rc == AOM_CODEC_OK

    def set_options(self, opts: dict) -> dict:
        return {k: self.set_option(k, v) for k, v in opts.items()}

    def _drain(self):
        out = []
        it = ctypes.c_void_p(None)
        while True:
            pkt = self._lib.aom_codec_get_cx_data(self._ctx,
                                                  ctypes.byref(it))
            if not pkt:
                break
            raw = ctypes.string_at(pkt, 32)
            kind = int(np.frombuffer(raw[:4], dtype="<u4")[0])
            if kind != 0:  # AOM_CODEC_CX_FRAME_PKT
                continue
            buf = int(np.frombuffer(raw[8:16], dtype="<u8")[0])
            sz = int(np.frombuffer(raw[16:24], dtype="<u8")[0])
            out.append(ctypes.string_at(buf, sz))
        return out

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Encode one frame; returns list of temporal-unit byte strings."""
        lib = self._lib
        hbd = self._bd > 8
        fmt = AOM_IMG_FMT_I42016 if hbd else AOM_IMG_FMT_I420
        img = lib.aom_img_alloc(None, fmt, self._w, self._h, 32)
        if not img:
            raise AomError("aom_img_alloc failed")
        try:
            if hbd:
                # high-bitdepth images report bit_depth 16 storage; set the
                # sample depth field so the encoder reads 10-bit values
                lay = _image_layout()
                ctypes.memmove(img + lay.bit_depth,
                               int(self._bd).to_bytes(4, "little"), 4)
            _fill_image(img, y, u, v, hbd)
            rc = lib.aom_codec_encode(self._ctx, img, self._pts, 1, 0)
            if rc != AOM_CODEC_OK:
                detail = lib.aom_codec_error_detail(self._ctx)
                raise AomError(
                    f"encode rc={rc}: {detail and detail.decode()}")
            self._pts += 1
            return self._drain()
        finally:
            lib.aom_img_free(img)

    def flush(self):
        rc = self._lib.aom_codec_encode(self._ctx, None, self._pts, 1, 0)
        if rc != AOM_CODEC_OK:
            raise AomError(f"flush rc={rc}")
        return self._drain()

    def close(self):
        if self._open:
            self._lib.aom_codec_destroy(self._ctx)
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def encode_frames(frames, w, h, **kw) -> list:
    """Encode [(y,u,v), ...]; returns one TU byte string per frame."""
    with Encoder(w, h, **kw) as e:
        tus = []
        for (y, u, v) in frames:
            tus.extend(e.encode(y, u, v))
        tus.extend(e.flush())
        return tus

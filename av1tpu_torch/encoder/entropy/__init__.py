# Copied from av1tpu/encoder/entropy/__init__.py (load_library, with the
# range encoder's prototypes).
"""The native spec-AV1 tile writer: build and load.

``native/`` holds the C++ range coder (``ec.cc``, ``ec.h``) and the tile
walker (``spec_tile.cc``), copied from the JAX package.  They compile
with ``g++`` at first use into ``av1tpu_torch/_build/``, keyed on a
content hash of the sources and flags (the bitstream depends on this
code, and checkouts do not preserve mtimes), and load through
``ctypes``.  ``specav1.native`` binds the tile writer's entry points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_build")
# -march=native is safe: the library is built per host at first use,
# never shipped
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
            "-funroll-loops", "-march=native", "-shared")
_SOURCES = ("ec.cc", "spec_tile.cc")
_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags: -march=native code is
    built for them, so a build directory copied to another host
    rebuilds."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        return b""
    keep = (b"model name", b"flags")
    return b"\n".join(next((ln for ln in lines if ln.startswith(k)), b"")
                      for k in keep)


def _src_hash() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + _host_cpu())
    for n in sorted(os.listdir(_NATIVE_DIR)):
        if n.endswith((".cc", ".h")):
            with open(os.path.join(_NATIVE_DIR, n), "rb") as f:
                h.update(n.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile the tile writer if its content hash is not built yet;
    returns the library path.  A failed build raises."""
    path = os.path.join(BUILD_DIR, f"libav1ec_{_src_hash()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-I", _NATIVE_DIR,
           "-o", tmp, *(os.path.join(_NATIVE_DIR, n) for n in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("g++ failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded tile-writer library (built on first call), with the
    range encoder's entry points prototyped for ``specav1.writer``'s
    ``TileWriter``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            vp = ctypes.c_void_p
            lib.ec_enc_create.restype = vp
            lib.ec_enc_reset.argtypes = [vp]
            lib.ec_enc_destroy.argtypes = [vp]
            lib.ec_enc_symbol_adapt.argtypes = [vp, ctypes.c_int, vp,
                                                ctypes.c_int]
            lib.ec_enc_bool.argtypes = [vp, ctypes.c_int, ctypes.c_uint]
            lib.ec_enc_literal.argtypes = [vp, ctypes.c_uint32,
                                           ctypes.c_int]
            lib.ec_enc_done.argtypes = [vp, vp, ctypes.c_int32]
            lib.ec_enc_done.restype = ctypes.c_int32
            _lib = lib
        return _lib

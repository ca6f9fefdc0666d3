# Copied from av1tpu/legacy/entropy_tile.py.
"""Python binding for the C++ tile syntax codec (legacy/native/tile.cc,
built into the port's tile library)."""

from __future__ import annotations

import ctypes

import numpy as np

from av1tpu_torch.encoder import entropy


def _lib():
    lib = entropy.load_library()
    if not hasattr(lib, "_tile_configured"):
        lib.tile_encode_intra.restype = ctypes.c_int32
        lib.tile_encode_intra.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.tile_decode_intra.restype = ctypes.c_int32
        lib.tile_decode_intra.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._tile_configured = True
    return lib


def encode_tile_intra(skips: np.ndarray, y_modes: np.ndarray,
                      uv_modes: np.ndarray, y_levels: np.ndarray,
                      u_levels: np.ndarray, v_levels: np.ndarray,
                      luma_n: int = 16, chroma_n: int = 8) -> bytes:
    """Serialize one intra tile.  Levels are raster-order int32 per block."""
    lib = _lib()
    n_blocks = len(skips)
    skips = np.ascontiguousarray(skips, np.uint8)
    y_modes = np.ascontiguousarray(y_modes, np.uint8)
    uv_modes = np.ascontiguousarray(uv_modes, np.uint8)
    y_levels = np.ascontiguousarray(y_levels, np.int32)
    u_levels = np.ascontiguousarray(u_levels, np.int32)
    v_levels = np.ascontiguousarray(v_levels, np.int32)
    cap = 256 + y_levels.nbytes + u_levels.nbytes + v_levels.nbytes
    out = np.zeros(cap, np.uint8)
    size = lib.tile_encode_intra(
        n_blocks, luma_n, chroma_n,
        skips.ctypes.data, y_modes.ctypes.data, uv_modes.ctypes.data,
        y_levels.ctypes.data, u_levels.ctypes.data, v_levels.ctypes.data,
        out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError("tile_encode_intra: output buffer too small")
    return out[:size].tobytes()


def decode_tile_intra(data: bytes, n_blocks: int, luma_n: int = 16,
                      chroma_n: int = 8):
    """Inverse of encode_tile_intra.  Returns (skips, y_modes, uv_modes,
    y_levels, u_levels, v_levels)."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8).copy()
    skips = np.zeros(n_blocks, np.uint8)
    y_modes = np.zeros(n_blocks, np.uint8)
    uv_modes = np.zeros(n_blocks, np.uint8)
    y_levels = np.zeros((n_blocks, luma_n * luma_n), np.int32)
    u_levels = np.zeros((n_blocks, chroma_n * chroma_n), np.int32)
    v_levels = np.zeros((n_blocks, chroma_n * chroma_n), np.int32)
    rc = lib.tile_decode_intra(
        buf.ctypes.data, len(buf), n_blocks, luma_n, chroma_n,
        skips.ctypes.data, y_modes.ctypes.data, uv_modes.ctypes.data,
        y_levels.ctypes.data, u_levels.ctypes.data, v_levels.ctypes.data)
    if rc != 0:
        raise ValueError("tile_decode_intra: corrupt tile data")
    return skips, y_modes, uv_modes, y_levels, u_levels, v_levels


def _lib_inter():
    lib = _lib()
    if not hasattr(lib, "_tile_inter_configured"):
        lib.tile_encode_inter.restype = ctypes.c_int32
        lib.tile_encode_inter.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.tile_decode_inter.restype = ctypes.c_int32
        lib.tile_decode_inter.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._tile_inter_configured = True
    return lib


def encode_tile_inter(skips: np.ndarray, mvs: np.ndarray,
                      y_levels: np.ndarray, u_levels: np.ndarray,
                      v_levels: np.ndarray, luma_n: int = 16,
                      chroma_n: int = 8, refs: np.ndarray = None,
                      txs: np.ndarray = None) -> bytes:
    """Serialize one inter tile.  mvs (B, 2) int32 q4 (dy, dx); refs
    (B,) uint8 (0=last, 1=golden) or None for single-reference tiles;
    txs (B,) uint8 luma transform (0=DCT 1=ADST 2=IDTX; None → DCT)."""
    lib = _lib_inter()
    n_blocks = len(skips)
    skips = np.ascontiguousarray(skips, np.uint8)
    mvs = np.ascontiguousarray(mvs, np.int32)
    y_levels = np.ascontiguousarray(y_levels, np.int32)
    u_levels = np.ascontiguousarray(u_levels, np.int32)
    v_levels = np.ascontiguousarray(v_levels, np.int32)
    use_refs = refs is not None
    refs_arr = (np.ascontiguousarray(refs, np.uint8) if use_refs
                else np.zeros(1, np.uint8))
    txs_arr = (np.ascontiguousarray(txs, np.uint8) if txs is not None
               else np.zeros(n_blocks, np.uint8))
    cap = 256 + 16 * n_blocks + y_levels.nbytes + u_levels.nbytes + v_levels.nbytes
    out = np.zeros(cap, np.uint8)
    size = lib.tile_encode_inter(
        n_blocks, luma_n, chroma_n, skips.ctypes.data, mvs.ctypes.data,
        refs_arr.ctypes.data, int(use_refs), txs_arr.ctypes.data,
        y_levels.ctypes.data, u_levels.ctypes.data, v_levels.ctypes.data,
        out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError("tile_encode_inter: output buffer too small")
    return out[:size].tobytes()


def decode_tile_inter(data: bytes, n_blocks: int, luma_n: int = 16,
                      chroma_n: int = 8, use_refs: bool = False):
    """Inverse of encode_tile_inter:
    (skips, mvs, y_lv, u_lv, v_lv, refs, txs)."""
    lib = _lib_inter()
    buf = np.frombuffer(data, np.uint8).copy()
    skips = np.zeros(n_blocks, np.uint8)
    mvs = np.zeros((n_blocks, 2), np.int32)
    refs = np.zeros(n_blocks, np.uint8)
    txs = np.zeros(n_blocks, np.uint8)
    y_levels = np.zeros((n_blocks, luma_n * luma_n), np.int32)
    u_levels = np.zeros((n_blocks, chroma_n * chroma_n), np.int32)
    v_levels = np.zeros((n_blocks, chroma_n * chroma_n), np.int32)
    rc = lib.tile_decode_inter(
        buf.ctypes.data, len(buf), n_blocks, luma_n, chroma_n,
        int(use_refs), skips.ctypes.data, mvs.ctypes.data,
        refs.ctypes.data, txs.ctypes.data, y_levels.ctypes.data,
        u_levels.ctypes.data, v_levels.ctypes.data)
    if rc != 0:
        raise ValueError("tile_decode_inter: corrupt tile data")
    return skips, mvs, y_levels, u_levels, v_levels, refs, txs

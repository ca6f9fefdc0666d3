# Copied from av1tpu/media/y4m.py.
"""YUV4MPEG2 (.y4m) reader/writer: the uncompressed test vehicle for
the native >8-bit source path (the daemon's compressed sources decode
through cv2 at 8 bits; y4m carries 10-bit pixels losslessly).

Supported colourspaces: C420 / C420jpeg / C420mpeg2 (8-bit) and
C420p10 (10-bit little-endian u16), the ones our 4:2:0 pipeline codes.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator

import numpy as np


class Y4mError(Exception):
    pass


@dataclasses.dataclass
class Y4mHeader:
    width: int = 0
    height: int = 0
    fps_num: int = 25
    fps_den: int = 1
    bit_depth: int = 8
    colourspace: str = "C420"


MAGIC = b"YUV4MPEG2"


def parse_header(line: bytes) -> Y4mHeader:
    parts = line.strip().split(b" ")
    if not parts or parts[0] != MAGIC:
        raise Y4mError("not a YUV4MPEG2 stream")
    h = Y4mHeader()
    for p in parts[1:]:
        if not p:
            continue
        tag, val = p[:1], p[1:].decode("ascii", "replace")
        if tag == b"W":
            h.width = int(val)
        elif tag == b"H":
            h.height = int(val)
        elif tag == b"F":
            num, den = val.split(":")
            h.fps_num, h.fps_den = int(num), int(den)
        elif tag == b"C":
            h.colourspace = "C" + val
            if val.startswith("420p10"):
                h.bit_depth = 10
            elif val.startswith("420"):
                h.bit_depth = 8
            else:
                raise Y4mError(f"unsupported colourspace C{val}")
    if not h.width or not h.height:
        raise Y4mError("missing dimensions")
    return h


def read_frames(f: BinaryIO) -> tuple:
    """Returns (header, iterator of (y, u, v) numpy planes)."""
    line = f.readline(256)
    hdr = parse_header(line)
    w, h = hdr.width, hdr.height
    dt = np.uint16 if hdr.bit_depth > 8 else np.uint8
    bpp = 2 if hdr.bit_depth > 8 else 1
    ysz = w * h * bpp
    csz = (w // 2) * (h // 2) * bpp

    def gen() -> Iterator[tuple]:
        while True:
            fl = f.readline(256)
            if not fl:
                return
            if not fl.startswith(b"FRAME"):
                raise Y4mError(f"bad frame marker {fl[:16]!r}")
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf, dt, w * h).reshape(h, w)
            u = np.frombuffer(buf, dt, (w // 2) * (h // 2),
                              ysz).reshape(h // 2, w // 2)
            v = np.frombuffer(buf, dt, (w // 2) * (h // 2),
                              ysz + csz).reshape(h // 2, w // 2)
            yield y.copy(), u.copy(), v.copy()

    return hdr, gen()


def write(path: str, frames, fps=(24, 1), bit_depth: int = 8) -> None:
    """frames: iterable of (y, u, v) planes (uint8 or uint16)."""
    frames = list(frames)
    y0 = frames[0][0]
    h, w = y0.shape
    cs = "C420p10" if bit_depth > 8 else "C420mpeg2"
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 %s\n"
                % (w, h, fps[0], fps[1], cs.encode()))
        dt = np.uint16 if bit_depth > 8 else np.uint8
        for y, u, v in frames:
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(y, dt).tobytes())
            f.write(np.ascontiguousarray(u, dt).tobytes())
            f.write(np.ascontiguousarray(v, dt).tobytes())

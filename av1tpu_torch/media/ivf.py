# Copied from av1tpu/media/ivf.py.
"""IVF container for raw AV1 (or VPx) streams.

The simple test/bench container: 32-byte header + per-frame (size, pts)
headers.  Used by conformance tests and the kernel benchmarks; real output
goes through av1tpu_torch.media.mkv_mux.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

from av1tpu_torch.media.probe import FormatInfo, ProbeResult, StreamInfo

HEADER_SIZE = 32
FOURCC = {b"AV01": "av1", b"VP90": "vp9", b"VP80": "vp8"}


class IvfError(Exception):
    pass


def write_header(f: BinaryIO, width: int, height: int,
                 fps_num: int = 30, fps_den: int = 1,
                 num_frames: int = 0, fourcc: bytes = b"AV01") -> None:
    f.write(struct.pack("<4sHH4sHHIII", b"DKIF", 0, HEADER_SIZE, fourcc,
                        width, height, fps_num, fps_den, num_frames))
    f.write(b"\x00" * 4)  # reserved — header is 32 bytes total


def write_frame(f: BinaryIO, payload: bytes, pts: int) -> None:
    f.write(struct.pack("<IQ", len(payload), pts))
    f.write(payload)


def patch_frame_count(f: BinaryIO, num_frames: int) -> None:
    pos = f.tell()
    f.seek(24)
    f.write(struct.pack("<I", num_frames))
    f.seek(pos)


def read_header(f: BinaryIO) -> dict:
    raw = f.read(HEADER_SIZE)
    if len(raw) < HEADER_SIZE or raw[:4] != b"DKIF":
        raise IvfError("not an IVF file")
    (_sig, version, hdr_size, fourcc, width, height, fps_num, fps_den,
     num_frames) = struct.unpack("<4sHH4sHHIII", raw[:28])
    return {"version": version, "fourcc": fourcc, "width": width,
            "height": height, "fps_num": fps_num, "fps_den": fps_den,
            "num_frames": num_frames, "header_size": hdr_size}


def iter_frames(f: BinaryIO) -> Iterator[tuple[bytes, int]]:
    """Yield (payload, pts) pairs."""
    while True:
        hdr = f.read(12)
        if len(hdr) < 12:
            return
        size, pts = struct.unpack("<IQ", hdr)
        payload = f.read(size)
        if len(payload) < size:
            return
        yield payload, pts


def probe(file_path: str) -> ProbeResult:
    with open(file_path, "rb") as f:
        h = read_header(f)
        n = sum(1 for _ in iter_frames(f))
    fps = f"{h['fps_num']}/{h['fps_den']}" if h["fps_den"] else ""
    fmt = FormatInfo(format_name="ivf")
    if h["fps_den"] and h["fps_num"] and n:
        fmt.duration = f"{n * h['fps_den'] / h['fps_num']:.6f}"
    stream = StreamInfo(
        index=0,
        codec_name=FOURCC.get(h["fourcc"], "unknown"),
        codec_type="video",
        width=h["width"], height=h["height"],
        avg_frame_rate=fps, r_frame_rate=fps,
        disposition={"default": 1},
    )
    return ProbeResult(format=fmt, streams=[stream])

# Copied from av1tpu/utils/spool.py.
"""Encode spool: GOP-granular mid-file checkpoint/resume (SURVEY.md §5c).

The reference restarts a killed transcode from scratch (single opaque
ffmpeg exec); here every encoded frame payload is appended to a spool
file beside the temp output, so a restarted daemon resumes after the last
completed frame — the next frame simply opens a new GOP (bitstream-legal
anywhere).  The spool is deleted after a successful mux; a stale or
mismatched spool (source changed, different qindex/dims) is discarded.

Format: magic, then a length-prefixed JSON header (source signature,
qindex, dims), then records of [u32 payload_size | u8 is_key | payload].
Truncated trailing records (crash mid-write) are dropped on read.
"""

from __future__ import annotations

import json
import os
import struct
from typing import BinaryIO, Optional

MAGIC = b"AV1TPUSP"
VERSION = 1


def source_signature(path: str) -> dict:
    st = os.stat(path)
    return {"bytes": st.st_size, "mtime_ns": st.st_mtime_ns}


class SpoolWriter:
    def __init__(self, path: str, src_sig: dict, qindex: int,
                 width: int, height: int):
        self.path = path
        self._f: Optional[BinaryIO] = open(path + ".new", "wb")
        header = json.dumps({
            "version": VERSION, "src": src_sig, "qindex": qindex,
            "width": width, "height": height,
        }).encode()
        self._f.write(MAGIC + struct.pack("<I", len(header)) + header)
        os.replace(path + ".new", path)
        # reopen in append mode against the final name
        self._f.close()
        self._f = open(path, "ab")

    def append(self, payload: bytes, is_key: bool) -> None:
        assert self._f is not None
        self._f.write(struct.pack("<IB", len(payload), 1 if is_key else 0))
        self._f.write(payload)

    def flush(self) -> None:
        if self._f:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class SpoolAppender(SpoolWriter):
    """Append to an existing valid spool without rewriting the header."""

    def __init__(self, path: str):  # noqa: super().__init__ intentionally skipped
        self.path = path
        self._f = open(path, "ab")


def read_spool(path: str, src_sig: dict, qindex: int, width: int,
               height: int) -> Optional[list[tuple[bytes, bool]]]:
    """Returns complete frame records if the spool matches, else None."""
    try:
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                return None
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            if (header.get("version") != VERSION
                    or header.get("src") != src_sig
                    or header.get("qindex") != qindex
                    or header.get("width") != width
                    or header.get("height") != height):
                return None
            records: list[tuple[bytes, bool]] = []
            while True:
                hdr = f.read(5)
                if len(hdr) < 5:
                    break
                size, key = struct.unpack("<IB", hdr)
                payload = f.read(size)
                if len(payload) < size:
                    break  # truncated tail record: drop
                records.append((payload, bool(key)))
            return records
    except (OSError, ValueError, json.JSONDecodeError):
        return None


def delete(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass

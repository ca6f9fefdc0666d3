# Copied from av1tpu/media/ebml.py.
"""EBML primitives: the binary encoding layer under Matroska/WebM.

Reader and writer for EBML variable-length integers, element headers, and
typed payloads.  This replaces the container knowledge the reference
outsourced to the downloaded ffprobe/ffmpeg binaries (SURVEY.md §2 #16) —
probe and mux are in-repo here.

EBML in one paragraph: a document is a tree of elements; each element is
(id-vint, size-vint, payload).  IDs keep their length-marker bit (so 0xAE
and 0x1A45DFA3 are distinct namespaces by length); sizes strip the marker.
A size of all-ones at any length means "unknown" (used for streamed
Segments/Clusters).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Optional


class EbmlError(Exception):
    pass


# ---------------------------------------------------------------------------
# vint primitives

def read_vint_raw(f: BinaryIO) -> tuple[int, int, bool]:
    """Read one vint.  Returns (value_with_marker_stripped, length, is_unknown).

    Raises EOFError cleanly at end of stream.
    """
    b0 = f.read(1)
    if not b0:
        raise EOFError
    first = b0[0]
    if first == 0:
        raise EbmlError("invalid vint leading byte 0x00")
    length = 9 - first.bit_length()  # leading zeros + 1
    rest = f.read(length - 1)
    if len(rest) != length - 1:
        raise EOFError
    marker = 1 << (8 - length)
    value = first & (marker - 1)
    for byte in rest:
        value = (value << 8) | byte
    max_value = (1 << (7 * length)) - 1
    return value, length, value == max_value


def read_element_id(f: BinaryIO) -> int:
    """Read an element ID; keeps the marker bit (class convention)."""
    b0 = f.read(1)
    if not b0:
        raise EOFError
    first = b0[0]
    if first == 0:
        raise EbmlError("invalid element id")
    length = 9 - first.bit_length()
    if length > 4:
        raise EbmlError("element id longer than 4 bytes")
    rest = f.read(length - 1)
    if len(rest) != length - 1:
        raise EOFError
    value = first
    for byte in rest:
        value = (value << 8) | byte
    return value


def read_size(f: BinaryIO) -> Optional[int]:
    """Read a data-size vint; None means unknown size."""
    value, _length, unknown = read_vint_raw(f)
    return None if unknown else value


def encode_id(element_id: int) -> bytes:
    """IDs are stored verbatim (marker already included)."""
    n = max(1, (element_id.bit_length() + 7) // 8)
    return element_id.to_bytes(n, "big")


def encode_size(size: Optional[int], length: Optional[int] = None) -> bytes:
    """Encode a data size as a vint; size=None encodes 8-byte unknown."""
    if size is None:
        return b"\x01" + b"\xff" * 7
    if length is None:
        length = 1
        while size >= (1 << (7 * length)) - 1 and length < 8:
            length += 1
    if size >= (1 << (7 * length)) - 1:
        raise EbmlError(f"size {size} does not fit in {length}-byte vint")
    value = size | (1 << (7 * length))
    return value.to_bytes(length, "big")


# ---------------------------------------------------------------------------
# payload coders

def decode_uint(payload: bytes) -> int:
    return int.from_bytes(payload, "big")


def decode_sint(payload: bytes) -> int:
    return int.from_bytes(payload, "big", signed=True)


def decode_float(payload: bytes) -> float:
    if len(payload) == 4:
        return struct.unpack(">f", payload)[0]
    if len(payload) == 8:
        return struct.unpack(">d", payload)[0]
    if len(payload) == 0:
        return 0.0
    raise EbmlError(f"bad float size {len(payload)}")


def decode_string(payload: bytes) -> str:
    return payload.rstrip(b"\x00").decode("utf-8", errors="replace")


def encode_uint(value: int) -> bytes:
    n = max(1, (value.bit_length() + 7) // 8)
    return value.to_bytes(n, "big")


def encode_sint(value: int) -> bytes:
    n = max(1, ((value.bit_length() + 1) + 7) // 8)
    return value.to_bytes(n, "big", signed=True)


def encode_float(value: float) -> bytes:
    return struct.pack(">d", value)


# ---------------------------------------------------------------------------
# element tree access

class Element:
    """One parsed element header; payload read lazily."""

    __slots__ = ("id", "size", "offset", "payload_offset")

    def __init__(self, element_id: int, size: Optional[int], offset: int,
                 payload_offset: int):
        self.id = element_id
        self.size = size
        self.offset = offset
        self.payload_offset = payload_offset


def iter_elements(f: BinaryIO, end: Optional[int]) -> Iterator[Element]:
    """Iterate sibling elements from the current position up to ``end``.

    ``end`` is an absolute file offset, or None to read until EOF.
    Elements with unknown size are yielded; the caller decides how to
    descend (master elements) — iteration stops after one unknown-size
    element since its extent is undefined at this level.
    """
    while True:
        offset = f.tell()
        if end is not None and offset >= end:
            return
        try:
            element_id = read_element_id(f)
            size = read_size(f)
        except EOFError:
            return
        payload_offset = f.tell()
        yield Element(element_id, size, offset, payload_offset)
        if size is None:
            return  # caller must descend; siblings unreachable
        f.seek(payload_offset + size)


def read_payload(f: BinaryIO, el: Element) -> bytes:
    if el.size is None:
        raise EbmlError("cannot read payload of unknown-size element")
    f.seek(el.payload_offset)
    data = f.read(el.size)
    if len(data) != el.size:
        raise EOFError
    return data


# ---------------------------------------------------------------------------
# writer

def master(element_id: int, *children: bytes) -> bytes:
    """Serialize a master element with known size."""
    payload = b"".join(children)
    return encode_id(element_id) + encode_size(len(payload)) + payload


def uint_el(element_id: int, value: int) -> bytes:
    p = encode_uint(value)
    return encode_id(element_id) + encode_size(len(p)) + p


def sint_el(element_id: int, value: int) -> bytes:
    p = encode_sint(value)
    return encode_id(element_id) + encode_size(len(p)) + p


def float_el(element_id: int, value: float) -> bytes:
    p = encode_float(value)
    return encode_id(element_id) + encode_size(len(p)) + p


def string_el(element_id: int, value: str) -> bytes:
    p = value.encode("utf-8")
    return encode_id(element_id) + encode_size(len(p)) + p


def binary_el(element_id: int, value: bytes) -> bytes:
    return encode_id(element_id) + encode_size(len(value)) + value

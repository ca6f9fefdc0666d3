# Copied from av1tpu/specav1/obu.py.
"""AV1 OBU framing (spec §5.2/5.3): parse and emit.

A temporal unit is a sequence of OBUs; libaom emits
[TD] [SEQUENCE_HEADER] [FRAME] per keyframe TU with has_size=1.
"""

from __future__ import annotations

from dataclasses import dataclass

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_TILE_LIST = 8
OBU_PADDING = 15


@dataclass
class Obu:
    type: int
    payload: bytes
    temporal_id: int = 0
    spatial_id: int = 0


def parse_obus(data: bytes) -> list[Obu]:
    out = []
    pos = 0
    while pos < len(data):
        b0 = data[pos]
        if b0 & 0x80:
            raise ValueError("obu_forbidden_bit set")
        otype = (b0 >> 3) & 0xF
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            tid = data[pos] >> 5
            sid = (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size = 0
            for i in range(8):
                byte = data[pos]
                pos += 1
                size |= (byte & 0x7F) << (7 * i)
                if not (byte & 0x80):
                    break
        else:
            size = len(data) - pos
        out.append(Obu(otype, data[pos:pos + size], tid, sid))
        pos += size
    return out


def make_obu(otype: int, payload: bytes) -> bytes:
    header = bytes([(otype << 3) | 0x02])  # has_size_field=1
    size = len(payload)
    leb = bytearray()
    while True:
        b = size & 0x7F
        size >>= 7
        leb.append(b | (0x80 if size else 0))
        if not size:
            break
    return header + bytes(leb) + payload


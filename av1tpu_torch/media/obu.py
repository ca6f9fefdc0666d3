# Copied from av1tpu/media/obu.py (the private av1tpu profile's OBU layer).
"""AV1 OBU framing, sequence header, and frame header.

OBU framing and the sequence-header field layout follow the AV1 spec
(obu_header / sequence_header_obu syntax); the frame-header payload uses
this codec's own simplified field layout (documented below) since the
tile payload syntax is also this codec's own (see
av1tpu_torch/legacy/native/tile.cc).  The bundled decoder is the
conformance reference (SURVEY.md §4a: "else our own inverse path").

Frame header layout (av1tpu profile v1):
  frame_type f(2) · show_frame f(1) · base_q_idx f(8) ·
  frame_width_minus_1 f(16) · frame_height_minus_1 f(16) ·
  luma_block_log2 f(3) · cdef_on f(1) · lr_mode f(2) ·
  tile_rows_log2 f(2) · two_ref f(1) · refresh f(1) · trailing_bits

Tile payload: tiles 0..T−2 are prefixed with a leb128 byte size; the last
tile runs to the end of the OBU.  Tiles split the frame into equal
horizontal stripes of block rows; each tile has independent entropy
contexts and loop filters do not cross tile boundaries (the sharded
encoder's stripes are exactly these tiles).
"""

from __future__ import annotations

import dataclasses

from av1tpu_torch.encoder.entropy.bitio import (BitReader, BitWriter, read_leb128,
                                          write_leb128)

# OBU types (AV1 spec)
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_PADDING = 15

KEY_FRAME = 0
INTER_FRAME = 1


def write_obu(obu_type: int, payload: bytes) -> bytes:
    """obu_header with has_size_field=1 + leb128 size + payload."""
    header = bytes([(obu_type << 3) | 0x02])  # forbidden=0, ext=0, has_size=1
    return header + write_leb128(len(payload)) + payload


def parse_obus(data: bytes) -> list[tuple[int, bytes]]:
    out = []
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        if hdr & 0x80:
            raise ValueError("forbidden bit set in OBU header")
        obu_type = (hdr >> 3) & 0xF
        has_ext = bool(hdr & 0x04)
        has_size = bool(hdr & 0x02)
        pos += 1
        if has_ext:
            pos += 1
        if has_size:
            size, pos = read_leb128(data, pos)
        else:
            size = len(data) - pos
        out.append((obu_type, data[pos:pos + size]))
        pos += size
    return out


@dataclasses.dataclass
class SequenceHeader:
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    seq_profile: int = 0
    seq_level_idx: int = 8        # level 4.0
    use_128x128_superblock: bool = False
    # ISO/IEC 23001-8 code points (0 = unsignaled); HDR10 sources carry
    # primaries=9/transfer=16/matrix=9 through from the container probe
    color_primaries: int = 0
    color_transfer: int = 0
    color_matrix: int = 0

    def write(self) -> bytes:
        """sequence_header_obu per AV1 spec field layout."""
        w = BitWriter()
        w.f(self.seq_profile, 3)
        w.f(0, 1)    # still_picture
        w.f(0, 1)    # reduced_still_picture_header
        w.f(0, 1)    # timing_info_present_flag
        w.f(0, 1)    # initial_display_delay_present_flag
        w.f(0, 5)    # operating_points_cnt_minus_1
        w.f(0, 12)   # operating_point_idc[0]
        w.f(self.seq_level_idx, 5)
        if self.seq_level_idx > 7:
            w.f(0, 1)  # seq_tier[0]
        wbits = max(1, (self.width - 1).bit_length())
        hbits = max(1, (self.height - 1).bit_length())
        w.f(wbits - 1, 4)
        w.f(hbits - 1, 4)
        w.f(self.width - 1, wbits)
        w.f(self.height - 1, hbits)
        w.f(0, 1)    # frame_id_numbers_present_flag
        w.f(1 if self.use_128x128_superblock else 0, 1)
        w.f(0, 1)    # enable_filter_intra
        w.f(0, 1)    # enable_intra_edge_filter
        w.f(0, 1)    # enable_interintra_compound
        w.f(0, 1)    # enable_masked_compound
        w.f(0, 1)    # enable_warped_motion
        w.f(0, 1)    # enable_dual_filter
        w.f(0, 1)    # enable_order_hint
        w.f(0, 1)    # seq_choose_screen_content_tools
        w.f(0, 1)    # seq_force_screen_content_tools
        w.f(0, 1)    # enable_superres
        w.f(0, 1)    # enable_cdef
        w.f(0, 1)    # enable_restoration
        # color_config
        w.f(1 if self.bit_depth == 10 else 0, 1)  # high_bitdepth
        w.f(0, 1)    # mono_chrome
        has_desc = bool(self.color_primaries or self.color_transfer
                        or self.color_matrix)
        w.f(1 if has_desc else 0, 1)  # color_description_present_flag
        if has_desc:
            w.f(self.color_primaries or 2, 8)   # 2 = unspecified
            w.f(self.color_transfer or 2, 8)
            w.f(self.color_matrix or 2, 8)
        w.f(0, 1)    # color_range
        w.f(0, 2)    # chroma_sample_position (420 implied by profile 0)
        w.f(0, 1)    # separate_uv_delta_q
        w.f(0, 1)    # film_grain_params_present
        w.trailing_bits()
        return w.bytes()

    @classmethod
    def parse(cls, payload: bytes) -> "SequenceHeader":
        r = BitReader(payload)
        sh = cls()
        sh.seq_profile = r.f(3)
        r.f(1)  # still_picture
        reduced = r.f(1)
        if reduced:
            raise ValueError("reduced_still_picture_header unsupported")
        if r.f(1):
            raise ValueError("timing_info unsupported")
        r.f(1)  # initial_display_delay
        op_cnt = r.f(5) + 1
        for _ in range(op_cnt):
            r.f(12)
            lvl = r.f(5)
            if lvl > 7:
                r.f(1)
        sh.seq_level_idx = lvl
        wbits = r.f(4) + 1
        hbits = r.f(4) + 1
        sh.width = r.f(wbits) + 1
        sh.height = r.f(hbits) + 1
        r.f(1)  # frame_id_numbers
        sh.use_128x128_superblock = bool(r.f(1))
        for _ in range(7):  # filter_intra..dual_filter + order_hint
            r.f(1)
        r.f(1)  # choose_sct
        r.f(1)  # force_sct
        r.f(1)  # superres
        r.f(1)  # cdef
        r.f(1)  # restoration
        sh.bit_depth = 10 if r.f(1) else 8
        r.f(1)  # mono
        if r.f(1):
            sh.color_primaries = r.f(8)
            sh.color_transfer = r.f(8)
            sh.color_matrix = r.f(8)
        r.f(1)  # color_range
        r.f(2)  # chroma_sample_position
        r.f(1)  # separate_uv_delta_q
        r.f(1)  # film_grain
        return sh


@dataclasses.dataclass
class FrameHeader:
    frame_type: int = KEY_FRAME
    show_frame: bool = True
    base_q_idx: int = 96
    width: int = 0
    height: int = 0
    luma_block_log2: int = 4
    cdef_on: bool = True    # frame-level CDEF gate (kernels/cdef)
    lr_mode: int = 0        # loop restoration preset (kernels/restoration)
    tile_rows_log2: int = 0  # frame splits into 2^n independent tile rows
    two_ref: bool = False   # inter tiles carry per-block ref select
    refresh: bool = True    # frame becomes the next "last" reference
    # (refresh=0 = non-reference frame, e.g. a one-frame scene flash:
    # the AV1 refresh_frame_flags analog)

    def write(self) -> bytes:
        w = BitWriter()
        w.f(self.frame_type, 2)
        w.f(1 if self.show_frame else 0, 1)
        w.f(self.base_q_idx, 8)
        w.f(self.width - 1, 16)
        w.f(self.height - 1, 16)
        w.f(self.luma_block_log2, 3)
        w.f(1 if self.cdef_on else 0, 1)
        w.f(self.lr_mode, 2)
        w.f(self.tile_rows_log2, 2)
        w.f(1 if self.two_ref else 0, 1)
        w.f(1 if self.refresh else 0, 1)
        w.trailing_bits()
        return w.bytes()

    @classmethod
    def parse(cls, payload: bytes) -> tuple["FrameHeader", int]:
        """Returns (header, byte_length_of_header)."""
        r = BitReader(payload)
        fh = cls()
        fh.frame_type = r.f(2)
        fh.show_frame = bool(r.f(1))
        fh.base_q_idx = r.f(8)
        fh.width = r.f(16) + 1
        fh.height = r.f(16) + 1
        fh.luma_block_log2 = r.f(3)
        fh.cdef_on = bool(r.f(1))
        fh.lr_mode = r.f(2)
        fh.tile_rows_log2 = r.f(2)
        fh.two_ref = bool(r.f(1))
        fh.refresh = bool(r.f(1))
        if r.f(1) != 1:
            raise ValueError("bad trailing bit in frame header")
        r.byte_align()
        return fh, r.bit_pos // 8


def write_frame_obu(fh: FrameHeader, tile_data) -> bytes:
    """OBU_FRAME = frame header (byte aligned) + tile payload.

    tile_data: bytes (single tile) or list[bytes] (size-prefixed tiles,
    last tile unprefixed).
    """
    if isinstance(tile_data, (list, tuple)):
        parts = []
        for i, t in enumerate(tile_data):
            if i < len(tile_data) - 1:
                parts.append(write_leb128(len(t)))
            parts.append(t)
        payload = b"".join(parts)
    else:
        payload = tile_data
    return write_obu(OBU_FRAME, fh.write() + payload)


def split_tiles(payload: bytes, n_tiles: int) -> list[bytes]:
    """Inverse of the multi-tile packing."""
    if n_tiles <= 1:
        return [payload]
    out = []
    pos = 0
    for _ in range(n_tiles - 1):
        size, pos = read_leb128(payload, pos)
        out.append(payload[pos:pos + size])
        pos += size
    out.append(payload[pos:])
    return out


def av1c_record(sh: SequenceHeader) -> bytes:
    """AV1CodecConfigurationRecord for Matroska CodecPrivate / MP4 av1C."""
    b0 = 0x81  # marker=1, version=1
    b1 = (sh.seq_profile << 5) | sh.seq_level_idx
    high_bd = 1 if sh.bit_depth == 10 else 0
    b2 = (0 << 7) | (high_bd << 6) | (0 << 5) | (0 << 4) | (1 << 3) | (1 << 2) | 0
    b3 = 0
    return bytes([b0, b1, b2, b3]) + write_obu(OBU_SEQUENCE_HEADER, sh.write())
